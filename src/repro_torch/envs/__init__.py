"""Environments of the port (so far: the token MDP of LM-PPO training)."""
