"""The two CartPole learning bars of tests/test_learning.py, held by the
PyTorch port on the CPU at seed 0 (the JAX fixture's ``PRNGKey(0)``):
PPO after 60 iterations of 16 envs x horizon 64 must reach an average
return above 100, A2C after 80 iterations of 16 envs x horizon 32 (GAE
lambda 0.95) above 50.  Both train with Adam 7e-4, grad clip 1.0 and
entropy 0.01, and are scored as the JAX tests score them: the episodes
that end in 8 stochastic collects of the training sampler
(``quickstart.eval_return``).  A random policy scores about 22.
chip_smoke.py holds the same bars on the card."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import quickstart  # noqa: E402


@pytest.mark.parametrize("name", ["ppo", "a2c"])
def test_cartpole_learning_bar(name):
    ret = quickstart.learning_bar(name, seed=0, device="cpu")
    bar = quickstart.BARS[name]["threshold"]
    assert ret > bar, f"{name} cartpole return {ret} <= {bar}"
