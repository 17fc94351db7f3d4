"""Hand-written Hopper kernels for the PyTorch port, one per Pallas TPU
kernel of the JAX package (ported so far: flash attention).

- flash_attention: fused online-softmax GQA attention (causal, sliding
  window, logit softcap, per-sequence kv_len) — CUDA C++ for sm_90a in
  ``csrc/flash_attention.cu``, built by ``kernels/build.py`` at first use.
"""
