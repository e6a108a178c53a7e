# Frozen copy of the modules of open_ludwig_torch that the benchmark's reference
# needs (host builders and plain PyTorch versions), at commit 8d8a57a.
"""The port's host builders and plain versions, frozen as the benchmark's reference.

Each file names the file of `open_ludwig_torch` it was copied from.  The
only edits: logger names, and the native library's build directory
(`build/lbm_bench_native/` in the checkout).  Nothing here imports the
program, so a change to the program cannot move the reference.
"""
