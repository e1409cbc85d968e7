"""Optimizers and the compressed gradient all-reduce.

The port's counterpart of ``repro/optim``:

* :mod:`repro_torch.optim.adamw` — AdamW with the MiniCPM WSD
  (warmup-stable-decay) schedule, plain tensor code over nested
  dict / list parameters.
* :mod:`repro_torch.optim.grad_compress` — int8 error-feedback gradient
  compression for the data-parallel all-reduce (the paper's
  communication-compression idea applied to gradients), quantizing through
  the ``quantize`` CUDA kernel on the card.
"""
