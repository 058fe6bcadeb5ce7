"""cor_tpu_torch — composed-object retrieval in PyTorch, with the TPU Pallas
kernels of ``cor_tpu`` rewritten by hand in CUDA for NVIDIA Hopper.

A port of ``cor_tpu``, module for module: each ``cor_tpu_torch.X`` is the
counterpart of ``cor_tpu.X`` and is tested against it. The package imports
``torch`` and never ``jax``. Ported so far: retrieval-only serving (the
SigLIP towers, mask pooling, fusion and projection of the query encoder, the
gallery scan and top-k, the JSON-lines server).

Layout
------
- ``cor_tpu_torch.ops``          functional ops and parameter holders
- ``cor_tpu_torch.ops.kernels``  wrappers of the CUDA kernels, each beside
                                 its plain PyTorch version
- ``cor_tpu_torch.csrc``         the CUDA sources, built at first use
- ``cor_tpu_torch.models``       SigLIP, pooling, fusion, support branch
- ``cor_tpu_torch.retrieval``    scan engine, index artifact, server
- ``cor_tpu_torch.utils``        the weight bridge from ``cor_tpu`` trees
- ``cor_tpu_torch.cli``          the serving entry point
"""

__version__ = "0.1.0"
