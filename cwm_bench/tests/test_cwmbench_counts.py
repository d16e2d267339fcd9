"""The frozen counts and traffic: equal to the port's current functions
where they are copies, and the roofline arithmetic on hand-worked cases.
Only these tests import the port's scripts; the harness never does."""
import pytest
import torch

from cwm_bench.counts import attention, lookup, raft, roofline, vit
from cwm_bench.traffic import prompts

LARGE = {'img_size': 224, 'patch_size': 4, 'tubelet_size': 1,
         'num_frames': 2, 'in_chans': 3, 'encoder_embed_dim': 1024,
         'encoder_depth': 24, 'encoder_num_heads': 16,
         'decoder_embed_dim': 512, 'decoder_depth': 12,
         'decoder_num_heads': 8, 'mlp_ratio': 4.0, 'qkv_bias': True}
BASE = dict(LARGE, patch_size=8, encoder_embed_dim=768, encoder_depth=12,
            encoder_num_heads=12, decoder_embed_dim=384, decoder_depth=4,
            decoder_num_heads=6)


def _port_model(v):
    from counterfactualworldmodels_tpu_torch.models import vmae
    return vmae.PretrainVisionTransformer(
        img_size=(v['img_size'],) * 2, patch_size=(v['patch_size'],) * 2,
        encoder_embed_dim=v['encoder_embed_dim'],
        encoder_depth=v['encoder_depth'],
        encoder_num_heads=v['encoder_num_heads'],
        decoder_embed_dim=v['decoder_embed_dim'],
        decoder_depth=v['decoder_depth'],
        decoder_num_heads=v['decoder_num_heads'])


@pytest.mark.parametrize('v,s,pools', [(LARGE, 256, (4, 4)),
                                       (BASE, 16, (2, 1))])
def test_vit_flops_is_the_ports(v, s, pools):
    from counterfactualworldmodels_tpu_torch.scripts import bench
    assert vit.vit_flops(v, s, 33, *pools) == bench.vit_flops(
        _port_model(v), s, 33, *pools)


@pytest.mark.parametrize('s,iters', [(256, 24), (16, 12)])
def test_raft_flops_is_the_ports(s, iters):
    from counterfactualworldmodels_tpu_torch.scripts import bench
    assert raft.raft_flops(s, 224, iters) == bench.raft_flops(s, 224, iters)


@pytest.mark.parametrize('v,b,n_vis', [(LARGE, 8, 3450), (BASE, 32, 800)])
def test_vmae_train_flops_is_the_ports(v, b, n_vis):
    from counterfactualworldmodels_tpu_torch.training import flops
    assert vit.vmae_train_flops(v, b, n_vis) == flops.vmae_train_flops(
        _port_model(v), b, n_vis)


def test_roofline_hand_worked():
    # 989 GFLOP and 1 GB: the FLOPs bound (1 ms) beats the bytes (0.3 ms)
    assert roofline.least_seconds(989e9, 1e9) == pytest.approx(1e-3)
    assert roofline.share_percent(989e9, 1e9, 2e-3) == pytest.approx(50.0)
    # 3.35 GB and no FLOPs: 1 ms of bandwidth, in 4 ms is 25%
    assert roofline.share_percent(0.0, 3.35e9, 4e-3) == pytest.approx(25.0)
    assert roofline.share_percent(1.0, 1.0, 0.0) is None


def test_attention_counts_hand_worked():
    ops, nbytes = attention.fwd(2, 3, 5, 4, [(1, 7), (2, 11)])
    assert ops == 4 * 2 * 3 * 5 * (7 + 11) * 4
    # Q and O of 2 rows; the shared panel's K, V once, the own panel's twice
    assert nbytes == 2 * (2 * 2 * 3 * 5 * 4) + 2 * (2 * 3 * 7 * 4) \
        + 2 * (2 * 2 * 3 * 11 * 4)
    ops, nbytes = attention.bwd(1, 1, 10, 8)
    assert ops == 10 * 100 * 8 and nbytes == 8 * 80 * 2 + 4 * 10


def test_lookup_counts_hand_worked():
    # one level of 1 x 1, radius 1: the 4 x 4 window covers the one entry
    ops, nbytes = lookup.pyramid_lookup(1, 1, 1, 1, 1, out_elem=2)
    assert nbytes == 4 + 8 + 9 * 2 and ops == 7 * 9
    # 28 x 28, radius 4, one level: a window of 10 at position c covers
    # min(27, c + 5) - max(0, c - 4) + 1 entries
    cov = sum(min(27, c + 5) - max(0, c - 4) + 1 for c in range(28))
    assert lookup._covered(28, 28, 4, 0) == cov


@pytest.mark.parametrize('grid,s,passive', [(56, 64, 32), (8, 16, 8)])
def test_prompt_policy(grid, s, passive):
    """The demo policy as the port's scripts/_bench_common.demo_prompts
    draws it (frame 0 visible; ``passive`` passive and one active frame-1
    patch a sample; shifts in [-3, 3]), with every prompt showing exactly
    passive + 1 frame-1 patches after the shift."""
    p = prompts.draw(123456789012345, 3, grid * 4, grid, s, passive, 3,
                     torch.device('cpu'))
    n1 = grid * grid
    assert p.shifts.abs().max() <= 3
    target = p.active + p.shifts[:, 0] * grid + p.shifts[:, 1]
    ty = p.active // grid + p.shifts[:, 0]
    tx = p.active % grid + p.shifts[:, 1]
    assert ((ty >= 0) & (ty < grid) & (tx >= 0) & (tx < grid)).all()
    for i in range(s):
        shown = set(p.passive[i].tolist())
        assert len(shown) == passive
        assert int(p.active[i]) not in shown and int(target[i]) not in shown
    assert not p.passive_mask[0, :n1].any() and not p.active_mask[0, :n1].any()
    assert (~p.passive_mask[0, n1:]).sum(0).eq(passive).all()
    assert (~p.active_mask[0, n1:]).sum(0).eq(1).all()
    again = prompts.draw(123456789012345, 3, grid * 4, grid, s, passive, 3,
                         torch.device('cpu'))
    assert torch.equal(p.passive, again.passive)
    assert torch.equal(p.scene, again.scene)


def test_prompts_match_the_ports_counterfactual():
    """What the reference builds from a prompt is what the port's
    make_motion_counterfactual builds: the video and the shown patches."""
    from counterfactualworldmodels_tpu_torch.pipelines import perturbation
    from cwm_bench.reference import cf
    v = {'img_size': 32, 'patch_size': 4}
    p = prompts.draw(99, 0, 32, 8, 6, 5, 3, torch.device('cpu'))
    video, visible, masked = cf.prompt_video(p.scene, p.active, p.passive,
                                             p.shifts, v)
    x = p.scene[None].expand(2, -1, -1, -1)
    x_out, mask = perturbation.make_motion_counterfactual(
        x, p.passive_mask[0].T, p.active_mask[0].T, p.shifts,
        torch.zeros(6, 64), (1, 4, 4), n_vis_target=64 + 6)
    assert torch.equal(x_out, video)
    assert torch.equal(mask[:, 64:], masked)
