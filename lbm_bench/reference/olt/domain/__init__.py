# Frozen copy of open_ludwig_torch/domain/__init__.py at commit 8d8a57a, cut to what the reference runs: part of the benchmark's reference, which imports nothing of the program.
"""Host-side domain construction: voxelization, static fields, Bouzidi data."""
