"""The benchmark's plain reference of the detector it measures.

A frozen copy, in plain PyTorch, of what the measured package computes:
the DINO detector with its domain-adaptation heads (`model`), the
criterion with its Hungarian matcher and the AdamW step (`train`), and the
serving path's host resize, wire decode and post-processing (`serve`).
Multi-scale deformable attention is the grid-sample formulation of the
Deformable DETR paper's reference (`msda`). Nothing here imports the
measured package, JAX, or any compiled kernel: the reference is what the
benchmark's `correct` holds the measured package's outputs against.
"""
