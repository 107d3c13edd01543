"""graphchainer_torch — the PyTorch / CUDA port of graphchainer_tpu.

Every mode of the JAX package, rebuilt on PyTorch for the NVIDIA H100:

  cli.py / pipeline.py  read streaming -> batched alignment -> writers
  models/               ChainerModel (CLC mode), GraphAlignerModel (GA
                        mode, the CLC rescue), OptimalAlignerModel
  align/                fragment jobs and bands, chaining event packer,
                        polish glue, GAF emission (JAX-free host code)
  ops/                  torch device code: the fragment DP, the chaining
                        event sweep, the banded polish fill and backtrace
  csrc/                 hand-written CUDA kernels (sm_90a): frag_core.cu,
                        frag_wide.cu, polish_core.cu, polish_walk.cu
  parallel/             several devices in one process (device.py,
                        collectives.py, sharded_graph.py, mesh.py) and
                        several processes (multihost.py)
  tools.py              the auxiliary subcommands (python -m
                        graphchainer_torch.tools)

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
