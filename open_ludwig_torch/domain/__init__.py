"""Host-side domain construction: voxelization, static fields, Bouzidi data."""
