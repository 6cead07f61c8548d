"""Host-side analyses of the port's runs (``comm_bytes``)."""
