"""foodrec-tpu on PyTorch and CUDA: a port of the `foodrec_tpu` JAX package
to one NVIDIA H100.

The layout mirrors `foodrec_tpu` module for module (`config`, `data/`,
`ops/`, `common/`, `models/`, `engine/`, `utils/`), so each port module sits
where its JAX counterpart does. The port imports `torch` and never `jax`, and
nothing of `foodrec_tpu`: the framework-free host layer (yaml config, data
files, graph builders) is copied here.

Models are `nn.Module`s whose graph tables are registered buffers; entry
points run on `cuda` unless the caller passes `use_gpu: False`, and they raise
when CUDA is asked for and absent. The one TPU kernel of the JAX package, the
Pallas SpMM, is the hand-written CUDA kernel `csrc/spmm_csr.cu`.

This slice ports serving: CIKM_Model's graph propagation, by-user evaluation
and full-catalog top-k. Training arrives with the next slice (ROADMAP.md).
"""

__version__ = "0.1.0"
