"""Scale-out (port of mind_tpu/parallel): device meshes, parallel tree
solves, and the batched multi-scenario and Monte-Carlo simulators."""
