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

All six models train and serve through it. The experiment driver is
ported too: `python -m foodrec_tpu_torch.runner -m MODEL -d DATASET [--mg]`
runs `engine/quick_start.py`'s grid search, with Mirror Gradient,
checkpoints and resume, and the by-user, full-sort, sampled and study
evaluations, and `mesh_shape` scales it out over ranks of
torch.distributed (`parallel/`). The offline pipeline turns raw Food.com,
Allrecipes or generic files into the dataset (`data/preprocess_cli.py`),
its k-means on the card. What is left is in ROADMAP.md.
"""

__version__ = "0.1.0"
