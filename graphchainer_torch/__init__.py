"""graphchainer_torch — the PyTorch / CUDA port of graphchainer_tpu.

The co-linear chaining (CLC) main path of the JAX package, rebuilt on
PyTorch for an NVIDIA H100:

  cli.py / pipeline.py  read streaming -> batched alignment -> GAF writer
  models/chainer.py     ChainerModel.align_batch (CLC mode)
  align/                fragment jobs and bands, chaining event packer,
                        polish glue, GAF emission (JAX-free host code)
  ops/                  torch device code: the fragment DP, the chaining
                        event sweep, the banded polish fill and backtrace
  csrc/                 hand-written CUDA kernels (sm_90a) for the two
                        device hot spots: frag_core.cu, polish_core.cu

Every kernel sits beside a plain torch version of the same function.  A
wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.  The JAX package is the
reference: the tests hold this port to it, bit for bit, on the same
numpy inputs.

The port keeps its own copies of the host layer (constants, utils/, io/,
graph/, index/, native.py: each names its source) and imports neither jax
nor anything of graphchainer_tpu.  The C++ host runtime's source
(native/graphchainer_native.cpp, at the repository's root) is shared by
path and built into this package's own _build/.  convert.py builds the
port's objects from the fields of the JAX package's, for the tests.
"""

__version__ = "0.1.0"
