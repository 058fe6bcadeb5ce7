"""cor_tpu_torch — composed-object retrieval in PyTorch, with the TPU Pallas
kernels of ``cor_tpu`` rewritten by hand in CUDA for NVIDIA Hopper.

A port of ``cor_tpu``, module for module: each ``cor_tpu_torch.X`` is the
counterpart of ``cor_tpu.X`` and is tested against it. The package imports
``torch`` and never ``jax``. Ported so far: retrieval serving with a mask
decode for every candidate (the SigLIP towers, mask pooling, fusion and
projection of the query encoder, the gallery scan and top-k, the SAM prompt
encoder and mask decoder, the JSON-lines server), the gallery-index build
(the SAM image encoder), training (``cli.train``), and evaluation from files
(checkpoint import and export, the manifest dataset, ``cli.eval``).

Layout
------
- ``cor_tpu_torch.ops``          functional ops and parameter holders
- ``cor_tpu_torch.ops.kernels``  wrappers of the CUDA kernels, each beside
                                 its plain PyTorch version
- ``cor_tpu_torch.csrc``         the CUDA sources, built at first use
- ``cor_tpu_torch.models``       SigLIP, pooling, fusion, support branch, SAM
                                 encoder and decoder, the CORE model
- ``cor_tpu_torch.data``         synthetic triplets, the manifest dataset,
                                 the batching loader, the tokenizer
- ``cor_tpu_torch.retrieval``    scan engine, index artifact, server
- ``cor_tpu_torch.train``        losses, metrics, optimizers, steps,
                                 checkpoints, the epoch loop
- ``cor_tpu_torch.utils``        the weight bridge to and from ``cor_tpu``
                                 trees, the checkpoint loaders and exporters,
                                 the PNG reader and writer, meters,
                                 TensorBoard scalars
- ``cor_tpu_torch.native``       the host's data plane (Pillow-exact resize,
                                 PNG unfilter), C++ built at first use
- ``cor_tpu_torch.eval``         the validator: mask dumps, metric CSV
- ``cor_tpu_torch.cli``          the serving, index-build, retrieval,
                                 training, evaluation and export entry points
"""

__version__ = "0.1.0"
