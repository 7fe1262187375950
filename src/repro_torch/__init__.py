"""PyTorch/CUDA port of the DCS federated-learning system (``repro``).

The package imports ``torch`` and ``numpy`` only.  Its entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; on a CUDA tensor
every kernel of the selection path is a hand-written Hopper kernel
(``repro_torch/csrc``), on a CPU tensor its plain PyTorch version.
"""
