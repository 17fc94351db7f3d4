"""RL algorithms of the port (so far: GAE and the LM-scale PPO step)."""
