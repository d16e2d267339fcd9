"""Port parity: the interactive interface on the fast IMU-conditioned
generator (the flagship interactive workload) against the JAX package's,
on the CPU: the tiny padded conjoined predictor and flow2imu of
tests/test_fast_conjoined.py with RAFT at 1 iteration, the port's draws
replaying the JAX key schedule (``ImuDraws``), the JAX interface under
Agg and the port's against a stub axes object (no matplotlib). Patches
and shifts bitwise, flows within 1e-3 px, drawn images within 1e-3.
"""
import matplotlib
import numpy as np

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from counterfactualworldmodels_tpu import interface as jui  # noqa: E402
from counterfactualworldmodels_tpu.pipelines import imu as jimu  # noqa: E402
from counterfactualworldmodels_tpu_torch import interface as tui  # noqa: E402
from counterfactualworldmodels_tpu_torch.pipelines import imu as timu  # noqa

from torch_port_common import imu_wrappers  # noqa: E402
from test_torch_imu import ImuDraws  # noqa: E402
from test_torch_interface import (Event, StubAxes,  # noqa: E402
                                  assert_same_drawings, assert_same_state,
                                  drawn)


def test_interface_on_the_fast_imu_generator_matches_jax():
    """The flagship interactive workload: the IMU-conditioned generator on
    the fast engine; a click, 'f', then 'b' twice (the second batch
    reuses the cached (scene, IMU) prefix)."""
    (jw, jfw, jr, rp), (tw, tfw, tr) = imu_wrappers(1)
    kw = dict(raft_iters=1, imagenet_normalize_inputs=True, seed=0,
              engine='fast')
    jg = jimu.ImuConditionedFlowGenerator(
        predictor=jw, head_motion_predictor=jfw, flow_model=jr,
        flow_params=rp, **kw)
    tg = timu.ImuConditionedFlowGenerator(
        predictor=tw, head_motion_predictor=tfw, flow_model=tr,
        device='cpu', **kw)
    ImuDraws(tg, 0)
    rng = np.random.RandomState(11)
    x = rng.rand(1, 3, 64, 64).astype(np.float32)
    ui_kw = dict(x=x, size=(64, 64), max_shift=2, sample_batch_size=2,
                 show_ticks=False)
    stub = [StubAxes() for _ in range(4)]
    jfig, jaxes = plt.subplots(2, 2)
    ju = jui.CounterfactualPredictionInterface(jaxes, jg, **ui_kw)
    tu = tui.CounterfactualPredictionInterface(stub, tg, **ui_kw)
    for ev in (Event(20, 20), Event(20, 20, key='f'), Event(20, 20, key='b'),
               Event(20, 20, key='b')):
        ju(ev)
        tu(ev)
        assert_same_state(tu, ju)
    assert len(tu.flow_samples_list) == 5
    assert tg._conj_prefix_lru.misses == 1 and tg._conj_prefix_lru.hits >= 1
    assert_same_drawings(drawn(stub), drawn(jaxes.ravel()))
    plt.close(jfig)
