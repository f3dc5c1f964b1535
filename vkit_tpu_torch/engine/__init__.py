"""Engine layer: the content generators the host page planner runs (fonts,
char and char-and-font samplers, images, barcodes, seal impressions).

Counterpart of vkit_tpu/engine; the subpackages import on their own.
"""
