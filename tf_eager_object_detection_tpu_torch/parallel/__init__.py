"""Data parallelism over a `torch.distributed` process group: `multihost`
joins the group and says which rows of a global batch a rank loads,
`mesh` averages a training step's gradients over the group and replicates
a detector for eval. Spatial partitioning (the JAX `parallel/spatial.py`)
is not ported yet (ROADMAP item 8(c))."""
