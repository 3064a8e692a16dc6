"""The port's socket transport (``io/transport.py``) on localhost: the
pub/sub fan-out of the port's message dataclasses, the RPC round trip with
a remote error, and the port's node flying a closed loop with its
trajectory service behind an RPC socket and its commands published through
a pub/sub socket (CPU, float64), whose final state and commands are bitwise
those of the same flight without sockets: the transport touches no
number."""

import pickle
import time

import numpy as np
import pytest
import torch

from mpc_quad_ros_tpu_torch.io.transport import (TcpPublisher, TcpRpcClient, TcpRpcServer,
                                                 TcpSubscriber)
from mpc_quad_ros_tpu_torch.models.params import hummingbird_params
from mpc_quad_ros_tpu_torch.node import (ControlCommand, ControllerNode, LiveFrame, MotorPower,
                                         PositionCommand, SimLoop, TrajectoryRequest,
                                         TrajectoryServer)

torch.set_num_threads(1)

HOVER = np.array([0, 0, 3, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=float)


def _wait_for(pred, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_pubsub_roundtrip_dataclasses():
    pub = TcpPublisher()
    got_a, got_b = [], []
    sub_a = TcpSubscriber(pub.host, pub.port, got_a.append)
    sub_b = TcpSubscriber(pub.host, pub.port, got_b.append)
    assert _wait_for(lambda: len(pub._clients) == 2)

    msgs = [ControlCommand(bodyrates=np.array([0.1, 0.2, 0.3]), collective_thrust=9.81,
                           motors=np.array([0.1, 0.2, 0.3, 0.4], dtype=np.float32), stamp=1.5),
            PositionCommand(pos=np.array([1.0, 2.0, 3.0]), yaw=0.5, motors=np.full(4, 0.3)),
            MotorPower(m=np.full(4, 0.25), stamp=2.0),
            LiveFrame(t=0.1, x=HOVER, x_ref_chunk=np.zeros((5, 13)), x_horizon=np.ones((6, 13)),
                      target=np.array([0.0, 0.0, 3.0]))]
    for m in msgs:
        pub.publish(m)
    assert _wait_for(lambda: len(got_a) == len(msgs) and len(got_b) == len(msgs))
    for got in (got_a, got_b):
        for a, b in zip(got, msgs):
            assert type(a) is type(b)
            assert pickle.dumps(a) == pickle.dumps(b)      # field by field, dtypes kept

    # a dead subscriber does not break publishing
    sub_a.close()
    time.sleep(0.05)
    pub(msgs[0])
    assert _wait_for(lambda: len(got_b) == len(msgs) + 1)
    pub.close()
    sub_b.close()


def test_rpc_trajectory_service_roundtrip():
    server = TcpRpcServer(TrajectoryServer(sample_dt=0.01).handle)
    client = TcpRpcClient(server.host, server.port)
    req = TrajectoryRequest("line", np.array([0, 0, 0.0]), np.array([0, 0, 2.0]), v_max=2, a_max=2)
    traj = client.call(req)
    direct = TrajectoryServer(sample_dt=0.01).handle(req)
    np.testing.assert_array_equal(traj.x, direct.x)
    np.testing.assert_array_equal(traj.t, direct.t)

    # a remote exception comes back as a local error
    with pytest.raises(RuntimeError, match="unknown trajectory"):
        client.handle(TrajectoryRequest("bogus"))
    client.close()
    server.close()


class ShortLine(TrajectoryServer):
    """0.1 m along x from hover at 4 m/s and 4 m/s^2."""

    def handle(self, req):
        return super().handle(TrajectoryRequest("line", np.array([0, 0, 3.0]),
                                                np.array([0.1, 0, 3.0]), v_max=4.0, a_max=4.0))


def _flight(server, publish):
    p = hummingbird_params(dtype=torch.float64)
    node = ControllerNode(p, server, dtype=torch.float64, device="cpu", v_max=4.0, a_max=4.0,
                          publish_control=publish)
    return node, SimLoop(node, p, HOVER).run(max_ticks=2000)


def test_closed_loop_over_sockets_is_bitwise_the_direct_flight():
    direct = []
    node_d, x_direct = _flight(ShortLine(sample_dt=0.01), direct.append)

    rpc = TcpRpcServer(ShortLine(sample_dt=0.01).handle)
    traj_client = TcpRpcClient(rpc.host, rpc.port)
    pub = TcpPublisher()
    received, sent = [], []
    sub = TcpSubscriber(pub.host, pub.port, received.append)
    assert _wait_for(lambda: len(pub._clients) == 1)

    def publish(cmd):
        sent.append(cmd)
        pub(cmd)

    try:
        node, x_final = _flight(traj_client, publish)
        assert node.finished and node_d.finished
        assert x_final.tobytes() == x_direct.tobytes()
        np.testing.assert_allclose(x_final[:3], [0.1, 0, 3.0], atol=0.5)
        # one command a control tick, received as sent, equal to the direct flight's
        assert len(sent) == len(direct) == node.idx_traj
        assert _wait_for(lambda: len(received) == len(sent))
        assert all(isinstance(c, ControlCommand) for c in received)
        for a, b, c in zip(received, sent, direct):
            assert pickle.dumps(a) == pickle.dumps(b) == pickle.dumps(c)
    finally:
        pub.close()
        sub.close()
        traj_client.close()
        rpc.close()
