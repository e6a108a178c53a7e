"""Measurement tools of the port (run with `python -m open_ludwig_torch.tools.<name>`)."""
