"""PyTorch/CUDA port of inspektor_gadget_tpu's sketch-ingest path.

The JAX package beside it is the reference; this package imports
nothing of it and no JAX. Entry points take ``device=`` and default to
``"cuda"``; asking for CUDA where there is none raises.
"""
