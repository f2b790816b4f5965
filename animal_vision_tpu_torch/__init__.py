"""animal-vision on PyTorch and CUDA (NVIDIA Hopper).

The second package beside ``animal_vision_tpu``: the same species behind the
same ``Animal.visualize(frame) -> (baseline, transformed)`` contract, with
every kernel of the JAX package's Pallas code written by hand for sm_90a.
This package imports neither JAX nor ``animal_vision_tpu``.

Covered so far (``species``): the 20 non-UV species, whose uint8 path runs
the three kernels in ``csrc/fused_nonuv.cu``, and the UV species honeybee,
goldfish, reindeer and kestrel on the analytic spectral path, whose blurs
run the kernel in ``csrc/fused_blur.cu``, or with MST++ inference
(``models``) as their spectral provider, whose convolutions and attention
blocks run the four kernels in ``csrc/fused_msab.cu``.
"""

__version__ = "0.1.0"
