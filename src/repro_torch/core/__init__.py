"""Region / policy / ledger spine of the port (counterpart of ``repro.core``)."""
