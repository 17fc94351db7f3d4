"""repro_torch: the PyTorch / CUDA (NVIDIA H100) port of the JAX package
``repro``.

It mirrors ``src/repro/`` path for path for the modules it ports, imports
``torch`` and numpy and never ``jax`` or ``repro``, and runs its entry
points on ``cuda`` unless the caller passes ``device="cpu"``.  Ported so
far: the gemma2-2b serving path (prefill, KV-cache decode, continuous
batching) with a hand-written Hopper flash attention kernel; mamba2-1.3b
LM-PPO training with a hand-written SSD scan kernel; and prioritized DQN
on Catch (sampler, device replay, DQN, runner) with a hand-written
sum-tree sampling kernel.
"""
