"""dopt_torch.scripts — the port's acceptance harnesses (the chaos soak
and the serve soak), run as ``python -m dopt_torch.scripts.<name>``."""
