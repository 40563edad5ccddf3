"""The benchmark's plain reference: float32 PyTorch written from the published
descriptions, importing nothing of the program under test (``sisr_tpu_torch``) and
nothing of JAX.  One module per model family (``qrcan``, ``edsr``), each with
``param_shapes(sizes)`` and ``forward(params, x, meta, sizes, conv)``."""
