"""PyTorch and CUDA port of nbss_tpu for NVIDIA Hopper.

Imports torch, numpy, scipy and the standard library (and tensorboardX or
the ``pesq`` C extension when they are installed). Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``; without a card
they raise rather than fall back.
"""
