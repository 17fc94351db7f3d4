"""The SAC Pendulum learning bar of tests/test_learning.py, held by the
PyTorch port on the CPU at seed 0: SAC (hidden 64, twin critics, Adam 1e-3
with grad clip 1.0, init_alpha 0.2) through OffPolicyRunner and
DeviceReplay, 8 envs x horizon 32, capacity 16384, batch 128, 160
iterations of 32 updates after a warm-up of 1024 transitions.  Scored as the
JAX test scores it: the initial policy's return over 8 collects of a fresh
sampler must be below -500 (an untrained pendulum is bad), and the trained
policy's return over 8 stochastic collects of the training sampler
(``quickstart.eval_return``) must beat it by more than 100.  chip_smoke.py
holds the same bar on the card.  It trains on one CPU thread, so that the
parallel workers of a test run do not oversubscribe the cores."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import pendulum_qpg  # noqa: E402


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_sac_pendulum_learning_bar(one_thread):
    bar = pendulum_qpg.BAR
    before, after = pendulum_qpg.learning_bar(seed=0, device="cpu")
    assert before < bar["before_max"], f"untrained SAC pendulum {before}"
    assert after > before + bar["gain"], f"SAC pendulum {before} -> {after}"
