"""Port parity: the interactive interface (CounterfactualPredictionInterface)
and IterativePatchSelector against the JAX package's, on the CPU.

The same synthetic-event script (clicks, 'f', 'b', 'x', 'e', SHIFT, ALT,
'T') runs through the JAX interface and the port's, on the same weights,
under matplotlib's Agg backend; the port's also runs against a stub axes
object (no matplotlib at all), which must draw the same images. The
generators are the tiny FlowGenerator of tests/test_segmentation.py on
both engines (RAFT with 1 iteration; the IMU-conditioned generator is in
test_torch_interface_imu.py); the port's replays the JAX key schedule
(``JaxDraws``) and the interface's own draws are numpy's on both sides. Patches and shifts bitwise, videos within 1e-4,
flows within 1e-3 px, drawn images within 1e-3.
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import matplotlib
import pytest
import torch

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from counterfactualworldmodels_tpu import interface as jui  # noqa: E402
from counterfactualworldmodels_tpu.models import vmae as jvmae  # noqa: E402
from counterfactualworldmodels_tpu.models.raft import raft as jraft  # noqa
from counterfactualworldmodels_tpu.pipelines import patch_selector as jps  # noqa
from counterfactualworldmodels_tpu.pipelines import segmentation as jseg  # noqa
from counterfactualworldmodels_tpu_torch import interface as tui  # noqa: E402
from counterfactualworldmodels_tpu_torch.models import vmae as tvmae  # noqa
from counterfactualworldmodels_tpu_torch.models.raft import raft as traft  # noqa
from counterfactualworldmodels_tpu_torch.pipelines import (  # noqa: E402
    patch_selector as tps)
from counterfactualworldmodels_tpu_torch.pipelines import (  # noqa: E402
    segmentation as tseg)
from counterfactualworldmodels_tpu_torch.utils import weights  # noqa: E402

from torch_port_common import TINY, JaxDraws, assert_close  # noqa: E402

_init_vmae = jax.jit(jvmae.init_params, static_argnums=0)
_init_raft = jax.jit(jraft.init_raft_params, static_argnums=(0, 2))


@pytest.fixture(scope='module')
def nets():
    jm = jvmae.PretrainVisionTransformer(**TINY)
    params = _init_vmae(jm, jax.random.PRNGKey(0))
    tm = tvmae.PretrainVisionTransformer(**TINY)
    sd = weights.vmae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), 3, tm.full_patch_size)
    jr = jraft.RAFT(iters=1)
    rp = _init_raft(jr, jax.random.PRNGKey(1), 32)
    tr = traft.RAFT(iters=1, device='cpu')
    tr.load_state_dict(weights.raft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, rp)), strict=True)
    return (jm, params, jr, rp), (tm, sd, tr)


def flow_generators(nets, engine):
    (jm, params, jr, rp), (tm, sd, tr) = nets
    kw = dict(raft_iters=1, imagenet_normalize_inputs=True, seed=0,
              engine=engine)
    jg = jseg.FlowGenerator(predictor=jm, params=params, flow_model=jr,
                            flow_params=rp, **kw)
    tgs = []
    for _ in range(2):                  # one for Agg, one for the stub axes
        tg = tseg.FlowGenerator(predictor=tm, params=sd, flow_model=tr,
                                device='cpu', **kw)
        JaxDraws(tg, 0)
        tgs.append(tg)
    return jg, tgs


class StubAxes:
    """What the interface draws through, recorded: no matplotlib."""

    def __init__(self):
        self.drawn, self.titles, self.texts = [], [], []
        self.figure = types.SimpleNamespace(canvas=types.SimpleNamespace(
            mpl_connect=lambda name, fn: len(name),
            mpl_disconnect=lambda cid: None))

    def imshow(self, img, **kwargs):
        self.drawn.append(np.array(img, dtype=np.float64))

    def text(self, *args, **kwargs):
        texts = self.texts

        class Text:
            def set_text(self, s):
                texts.append(s)
        return Text()

    def set_title(self, title, **kwargs):
        self.titles.append(title)

    def set_xticks(self, ticks):
        pass

    def set_yticks(self, ticks):
        pass


class Event:
    def __init__(self, x, y, key=None, button=1):
        self.xdata, self.ydata = x, y
        self.key = key
        self.button = button
        self.dblclick = False


def drawn(axes):
    """The images drawn on each axes, in order."""
    out = []
    for ax in axes:
        if isinstance(ax, StubAxes):
            out.append(ax.drawn)
        else:
            out.append([np.array(im.get_array(), dtype=np.float64)
                        for im in ax.images])
    return out


def assert_same_drawings(a, b):
    """The same images on each axes; RGB images as matplotlib keeps them
    (clipped to [0, 1])."""
    assert [len(x) for x in a] == [len(x) for x in b]
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert x.shape == y.shape
            if x.ndim == 3 and x.shape[-1] == 3:
                x, y = np.clip(x, 0, 1), np.clip(y, 0, 1)
            np.testing.assert_allclose(x, y, atol=1e-3, rtol=1e-3)


def np_(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def assert_same_state(tu, ju):
    np.testing.assert_array_equal(np_(tu.active_patches),
                                  np_(ju.active_patches))
    np.testing.assert_array_equal(np_(tu.passive_patches),
                                  np_(ju.passive_patches))
    assert tu.shifts == ju.shifts and tu.shift == ju.shift
    assert len(tu.flow_samples_list) == len(ju.flow_samples_list)
    for a, b in zip(tu.flow_samples_list, ju.flow_samples_list):
        assert tuple(a.shape) == b.shape
        assert_close(a.numpy(), b, 1e-3)
    if ju._flow_corrs is None:
        assert tu._flow_corrs is None
    else:
        np.testing.assert_allclose(tu._flow_corrs.numpy(),
                                   np.asarray(ju._flow_corrs), atol=1e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize('engine', ['fast', 'exact'])
def test_interface_events_match_jax(nets, engine):
    jg, (tg, tg_stub) = flow_generators(nets, engine)
    x = np.random.RandomState(0).rand(1, 3, 32, 32).astype(np.float32)
    kw = dict(x=x, size=(32, 32), max_shift=2, sample_batch_size=2,
              show_ticks=False)
    jfig, jaxes = plt.subplots(2, 2)
    tfig, taxes = plt.subplots(2, 2)
    stub = [StubAxes() for _ in range(4)]
    ju = jui.CounterfactualPredictionInterface(jaxes, jg, **kw)
    tu = tui.CounterfactualPredictionInterface(taxes, tg, **kw)
    su = tui.CounterfactualPredictionInterface(stub, tg_stub, **kw)
    assert tu.device.type == 'cpu'
    uis = (tu, su)
    n_per = 64

    def checks(i):
        for u in uis:
            assert_same_state(u, ju)
        if i == 0:
            assert int((~tu.active_patches.numpy())[:, n_per:].sum()) == 1
        if i == 2:
            assert len(tu.flow_samples_list) == 1
            assert_close(tu.y.numpy(), ju.y, 1e-4)
            assert_close(tu.flow.numpy(), ju.flow, 1e-3)
        if i == 3:
            assert len(tu.flow_samples_list) == 3
        if i == 4:
            assert tu._flow_corrs is not None
        if i == 6:
            assert len(tu.flow_samples_list) == 0

    selectors = [
        cls(g, num_iters=1, samples_per_iter=2, sample_batch_size=2)
        for cls, g in ((jps.IterativePatchSelector, jg),
                       (tps.IterativePatchSelector, tg),
                       (tps.IterativePatchSelector, tg_stub))]
    for i, ev in enumerate([Event(12, 12), Event(20, 20, key='meta'),
                            Event(12, 12, key='f'), Event(12, 12, key='b'),
                            Event(12, 12, key='x'), Event(12, 12, key='e'),
                            Event(12, 12, key='shift'),
                            Event(12, 12, key='alt'),
                            Event(12, 12, key='T')]):
        for u in (ju, *uis):
            u(ev)
        checks(i)
    for u, sel in zip((ju, *uis), selectors):
        u.patch_selector = sel
        u(Event(12, 12))
        u(Event(12, 12, key='T'))
    for u in uis:
        assert_same_state(u, ju)
    assert len(tu.flow_samples_list) == len(ju.flow_samples_list) > 0
    assert_same_drawings(drawn(taxes.ravel()), drawn(jaxes.ravel()))
    assert_same_drawings(drawn(stub), drawn(taxes.ravel()))
    titles = [ax.get_title() for ax in jaxes.ravel()]
    assert [ax.get_title() for ax in taxes.ravel()] == titles
    assert [a.titles[-1] if a.titles else '' for a in stub] == titles
    assert tu.text.get_text() == ju.text.get_text()
    assert stub[0].texts[-1] == ju.text.get_text()
    if engine == 'fast':
        assert tg._prefix_lru.misses == 1 and tg._prefix_lru.hits >= 1
    plt.close(jfig)
    plt.close(tfig)


def test_patch_selector_matches_jax(nets):
    """Two iterations from a clicked patch: the grown active and passive
    sets bitwise, the flows within 1e-3, the filter masks equal."""
    jg, (tg, _) = flow_generators(nets, 'fast')
    rng = np.random.RandomState(5)
    x = rng.rand(1, 2, 3, 32, 32).astype(np.float32)
    active = np.ones((1, 128), dtype=bool)
    active[0, 64 + 27] = False
    kw = dict(num_iters=2, samples_per_iter=2, sample_batch_size=2)
    js = jps.IterativePatchSelector(jg, **kw)
    ts = tps.IterativePatchSelector(tg, **kw)
    jf, ja, jp = js(jnp.asarray(x), init_actives=jnp.asarray(active))
    tf, ta, tp = ts(x, init_actives=active)
    assert tuple(ta.shape) == ja.shape == (1, 128, 3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert_close(tf.numpy(), jf, 1e-3)
    np.testing.assert_array_equal(ts.filter_masks.numpy(),
                                  np.asarray(js.filter_masks))
    aff_t = ts.compute_affinity_targets_from_samples(tf)[0]
    aff_j = js.compute_affinity_targets_from_samples(jf)[0]
    assert_close(aff_t.numpy(), aff_j, 1e-3)
    # no filter: an empty mask set
    ts.do_filter = False
    ts(x, init_actives=active)
    assert tuple(ts.filter_masks.shape) == (1, 0)


@pytest.mark.parametrize('case', ['ties', 'taken'])
def test_patch_selector_grow_and_shrink_match_jax(case):
    """The argmax / argmin with the -inf / +inf masking of taken patches:
    ties break to the first index, as jnp's do; the grown patch never
    shrinks."""
    aff = np.zeros((2, 2, 2, 2), np.float32)        # flows [B,2,H,W]
    if case == 'ties':
        aff[:, 0] = 1.0                             # every patch ties
    else:
        aff[:, 0] = np.arange(4, dtype=np.float32).reshape(2, 2)
    flows = aff[..., None]                          # one sample

    class Gen:
        """Just what the selector reads from a generator."""
        patch_size = (1, 1)
        mask_shape = (2, 2, 2)
        flow_sample_filter = None

        def __init__(self, torch_side):
            self.torch_side = torch_side
            self.device = torch.device('cpu')

        def _tensor(self, v):
            return torch.as_tensor(np.asarray(v))

        def set_input(self, x):
            self.x = x

        def get_zeros_mask(self):
            m = np.zeros((2, 8), bool)
            m[:, 4:] = True
            return self._tensor(m) if self.torch_side else jnp.asarray(m)

        def predict_counterfactual_videos_and_flows(self, x, **kw):
            f = flows.transpose(0, 4, 1, 2, 3)[:, :, None]   # [B*S,1,2,H,W]
            return None, (torch.as_tensor(f[:, 0]) if self.torch_side
                          else jnp.asarray(f[:, 0]))

        def _batch_to_samples(self, f):
            return (torch.as_tensor(flows) if self.torch_side
                    else jnp.asarray(flows))

    init = np.zeros((2, 8), bool)
    init[:, 4:] = True
    init[0, 4] = False                               # patch 0 taken, row 0
    init[1, 7] = False                               # patch 3 taken, row 1
    x = np.zeros((2, 2, 3, 2, 2), np.float32)
    _, ja, jp = jps.IterativePatchSelector(Gen(False), num_iters=1)(
        jnp.asarray(x), init_actives=jnp.asarray(init))
    _, ta, tp = tps.IterativePatchSelector(Gen(True), num_iters=1)(
        x, init_actives=init)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize('overlay', [False, True])
def test_random_correlograms_run_on_the_port(nets, overlay):
    """The correlogram gallery (random prompts from the generator's mask
    generator, the covariance rows at the probe points, the overlay's
    resize) and the random-sample covariance probe, under Agg."""
    from counterfactualworldmodels_tpu_torch.masking import generators
    (_, _, _, _), (tm, sd, tr) = nets
    g = tseg.FlowGenerator(
        predictor=tm, params=sd, flow_model=tr, raft_iters=1,
        imagenet_normalize_inputs=True, device='cpu',
        mask_generator=generators.MaskingGenerator(
            (1, 8, 8), 0.9, visible_frames=1, device='cpu'))
    fig, axes = plt.subplots(2, 2)
    x = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    ui = tui.CounterfactualPredictionInterface(axes, g, x=x, size=(32, 32),
                                               covmat_downsample=2)
    ui.show_random_correlogram(10, 20, num_samples=2)
    assert len(ui.flow_samples_list) == 2 and ui._num_flow_samples == 2
    assert tuple(ui._flow_corrs.shape) == (1, 1, 16, 16, 16, 16)
    assert axes[0, 1].images[-1].get_array().shape == (16, 16)
    ui._corrmat_inds_list = [[4, 6]]
    points = ui.visualize_correlogram(num_points=3, num_samples=2,
                                      overlay=overlay)
    assert len(points) == 3 and points[0] == [4, 6]
    gallery = plt.gcf()
    panels = [a for a in gallery.axes if a.images]
    assert len(panels) == (3 if overlay else 6)
    assert all(p.images[0].get_array().shape[:2] in ((32, 32), (16, 16))
               for p in panels)
    plt.close('all')
