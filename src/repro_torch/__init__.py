"""PyTorch/CUDA port of the SPD serving stack (`src/repro/` is the JAX
reference it is held against).

Subpackages mirror `repro` name for name, so every file here names the
reference file it ports.  Tensor-parallel shards live on a leading
shard axis of size `tp` on every split parameter and cache leaf (the
reference's `sim` backend layout), which is how one GPU holds them.
The public entry point is `repro_torch.api.LLM`.
"""
