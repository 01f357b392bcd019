"""The env axis split across devices: ``mesh`` (the mesh, the split and
gather of batched trees, the cross-env mean, the process group) and
``sharded`` (the closed loop stepped one shard per device)."""
