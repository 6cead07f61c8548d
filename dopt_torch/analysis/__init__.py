"""Host-side analyses of the port's runs: ``comm_bytes``, the bytes on
the consensus wire (``python -m dopt_torch.analysis.comm_bytes``)."""
