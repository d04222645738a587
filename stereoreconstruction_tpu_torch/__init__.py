"""stereoreconstruction_tpu_torch — the PyTorch/CUDA port of
``stereoreconstruction_tpu``.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and semantics, and the tests hold each against the
JAX function it replaces.  This package imports ``torch`` and numpy only —
never JAX, and nothing of the JAX package.

Precision follows the reference: cameras and host preparation in float64,
the hot depth sweep in float32, point-cloud back-projection in float64.
The two TPU kernels of the multi-view path are hand-written CUDA for Hopper
(``csrc/``); each wrapper runs its plain PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"
