"""BoomHQ on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``src/repro/`` module for module (``vectordb/``,
``core/``, ``kernels/``, ``serve/``, ``bench/``, ``common/``, and the dense
language models' ``configs/``, ``models/`` and ``launch/``) so each
module's counterpart is found by name. Entry points place their tensors on
the CUDA device unless the caller passes ``device="cpu"``; the candidate
gather+score kernel is hand-written CUDA C++ for ``sm_90a``
(``csrc/gather_score.cu``), with a plain PyTorch version beside it that
serves CPU tensors.
"""
