"""The port's takeoff-and-land demo (``hello_world.py``) on the CPU against
the JAX package's, both float32 as the demo flies them (the crazyflie,
N=10, 0.5 m/s and 0.5 m/s^2), to a hover height of 0.1 m to keep the
flights short: ``main(["--cpu", ...])`` returns 0, both phases end within
0.05 m of their targets (the JAX test's bound), and the final states agree
with the JAX flights' within 2.5e-4 m (measured 9.1e-5 m here, 3.9e-5 at
0.25 m and 9.8e-6 at the demo's 1 m)."""

import numpy as np
import pytest
import torch

import mpc_quad_ros_tpu.hello_world as jhw
import mpc_quad_ros_tpu_torch.hello_world as thw

torch.set_num_threads(1)

HEIGHT = 0.1
FINAL_TOL = 2.5e-4


@pytest.fixture(scope="module")
def flights():
    """(main's exit code, the port's phases, the JAX package's phases)."""
    runs = []
    fly = thw.hello_world

    def recorded(*args, **kw):
        runs.append(fly(*args, **kw))
        return runs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thw, "hello_world", recorded)
        rc = thw.main(["--cpu", "--height", str(HEIGHT)])
    return rc, runs[0], jhw.hello_world(height=HEIGHT, hover_s=0.0, verbose=False)


def test_hello_world_takes_off_and_lands_on_the_cpu(flights):
    rc, port, _ = flights
    assert rc == 0
    assert port["takeoff"]["error_m"] < 0.05 and port["land"]["error_m"] < 0.05
    assert port["takeoff"]["x_final"][2] > 0.9 * HEIGHT
    assert port["land"]["x_final"][2] < 0.1


def test_hello_world_matches_jax(flights):
    _, port, ref = flights
    for phase in ("takeoff", "land"):
        assert port[phase]["x_final"].dtype == np.float32
        np.testing.assert_allclose(port[phase]["x_final"], np.asarray(ref[phase]["x_final"]),
                                   rtol=0, atol=FINAL_TOL, err_msg=phase)


def test_hello_world_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would fly on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        thw.main([])
