"""Data parallelism and spatial partitioning over a `torch.distributed`
process group: `multihost` joins the group and says which rows of a global
batch a rank loads, `mesh` averages a training step's gradients over the
group and replicates a detector for eval, and `spatial` shards each
image's rows over a space group of ranks (halo exchanges, the gather of
the extractor's outputs)."""
