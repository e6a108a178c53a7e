"""Multi-device execution: x-slab sharding of the dense-patch step
(`patch_shard`)."""
