"""Hand-written Hopper kernels for the PyTorch port, one per Pallas TPU
kernel of the JAX package (all three are ported).

- flash_attention: fused online-softmax GQA attention (causal, sliding
  window, logit softcap, per-sequence kv_len) — CUDA C++ for sm_90a in
  ``csrc/flash_attention.cu``: prefill on ``wgmma`` fed by TMA, decode split
  over the cache in one thread-block cluster a (batch, KV head).
- ssd_scan: the Mamba-2 SSD chunked scan (train forward; the backward
  recomputes through the plain chunked scan) — CUDA C++ for sm_90a in
  ``csrc/ssd_scan.cu``, every product on the tensor cores (``mma.sync``,
  the f32 operands as hi / lo bf16 pairs), one block per (batch, head).
- sum_tree: prioritized replay's stratified proportional sampling (block
  scan, binary search, a warp scan of one leaf row per sample) — CUDA C++
  for sm_90a in ``csrc/sum_tree.cu``.

All are built by ``kernels/build.py`` at first use.
"""
