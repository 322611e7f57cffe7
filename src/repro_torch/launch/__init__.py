"""Drivers of the port (counterpart of ``repro.launch``)."""
