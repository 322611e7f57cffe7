"""Step functions of the port (counterpart of ``repro.train``)."""
