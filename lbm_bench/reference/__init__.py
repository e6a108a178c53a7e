"""The benchmark's plain reference: `model.Reference` over the frozen
copies in `olt/`.  Imports nothing of the program and never jax."""
