"""PyTorch / CUDA port of the SFC-CA serving stack, for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (the reference, which this
package never imports): ``core`` (schedule compiler, GEMM backend switch,
Listing-1 reference), ``kernels`` (the hand-written CUDA SFC fused GEMM and
its plain version), ``models``, ``serving`` and ``launch``.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
