"""VMAE masked-prediction training steps, through
``training.train.make_train_step`` (the step ``train_vmae`` runs).

Set-up builds one train state (the model with weights made from the seed,
AdamW bound to its parameters) and drives it through the first
``checked_steps`` steps, through the window's own step and feed; those
steps are the warm-up, and their losses, the first gradient (as the
optimizer's first moment holds it) and the parameters' change are what
the output check reads. The window then keeps stepping the same state on
new clips until ``--seconds`` have passed, and fetches the last loss.
Clips are seeded and resident on the device: a frame and the same frame
rolled by up to ``max_shift_px`` pixels, with masks of the rotated-table
policy (frame 0 visible, frame 1 masked at exactly ``mask_ratio``), every
row different. Row i of a batch of B is random noise in its top i/(B-1)
of the image and flat blocks of 4 x 4 patches below, so the rows' losses
differ (a flat patch's normalised target is 0) and a step that dropped
part of the batch would read another loss.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from cwm_bench import weights
from cwm_bench.drivers import port_vmae
from cwm_bench.harness import Window
from cwm_bench.reference import precision
from cwm_bench.reference import train as ref_train
from cwm_bench.traffic.prompts import call_seed

POOL = 16          # distinct batches resident on the device; then they repeat


def n_visible(v: Dict, ratio: float) -> int:
    n0 = (v['img_size'] // v['patch_size']) ** 2
    return n0 + n0 - int(ratio * n0)


def make_batch(v: Dict, traffic: Dict, seed: int, c: int, device):
    """(clips [B, 2, 3, H, W] in [0, 1], masks bool [B, N]) of batch c."""
    g = torch.Generator(device=device)
    g.manual_seed(call_seed(seed, c, 5))
    b, hw = traffic['batch_size'], v['img_size']
    n0 = (hw // v['patch_size']) ** 2
    noise = torch.rand(b, 3, hw, hw, generator=g, device=device)
    blk = 4 * v['patch_size']
    blocks = torch.rand(b, 3, hw // blk, hw // blk, generator=g,
                        device=device)
    blocks = blocks.repeat_interleave(blk, 2).repeat_interleave(blk, 3)
    cut = torch.arange(b, device=device) * hw // max(b - 1, 1)
    top = torch.arange(hw, device=device)[None, None, :, None] < cut[
        :, None, None, None]
    base = torch.where(top, noise, blocks)
    shifts = torch.randint(-traffic['max_shift_px'], traffic['max_shift_px']
                           + 1, (b, 2), generator=g, device=device).tolist()
    f1 = torch.stack([torch.roll(base[i], tuple(shifts[i]), dims=(-2, -1))
                      for i in range(b)])
    clips = torch.stack([base, f1], dim=1)
    n_masked = int(traffic['mask_ratio'] * n0)
    order = torch.rand(b, n0, generator=g, device=device).argsort(dim=1)
    m1 = torch.zeros(b, n0, dtype=torch.bool, device=device)
    m1.scatter_(1, order[:, :n_masked], True)
    masks = torch.cat([torch.zeros_like(m1), m1], dim=1)
    return clips, masks


def _first_moment_norm(opt, p) -> float:
    """The norm of Adam's first moment of ``p`` (0 where the optimizer
    holds none: it took no step)."""
    m = opt.state.get(p, {}).get('exp_avg')
    return 0.0 if m is None else float(m.float().norm())


class Run:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from counterfactualworldmodels_tpu_torch.models import vmae
        from counterfactualworldmodels_tpu_torch.training import train as T
        self.cfg, self.traffic = config, traffic
        self.seed, self.dev = seed, device
        v, tr = config['vmae'], config['train']
        self.model = port_vmae(v, getattr(torch, config['dtype']),
                               'flash' if device.type == 'cuda' else 'dense')
        self.sd0 = weights.vmae_state_dict(v, seed, device)
        module = vmae.PretrainVisionTransformerModule(self.model, device)
        module.load_state_dict(self.sd0, strict=True)
        o = tr['optimizer']
        self.optimizer = T.make_optimizer(
            learning_rate=o['learning_rate'], weight_decay=o['weight_decay'],
            warmup_steps=o['warmup_steps'], total_steps=o['total_steps'],
            b1=o['b1'], b2=o['b2'], clip_norm=o['clip_norm'])
        self.state = T.TrainState(0, module,
                                  self.optimizer.init(module.parameters()))
        self.step = T.make_train_step(
            self.model, self.optimizer, n_visible(v, traffic['mask_ratio']),
            remat=tr['remat'], device=device)
        self.batches = [make_batch(v, traffic, seed, c, device)
                        for c in range(POOL)]
        self.n_checked = traffic['checked_steps']
        self.program: Dict = {}
        self.profile_units = 1
        self._next = 0

    def _step(self):
        clips, masks = self.batches[self._next % POOL]
        self._next += 1
        return self.step(self.state, clips, masks)[1]

    def warmup(self):
        """The checked steps, read as the optimizer and the parameters
        hold them."""
        module, opt = self.state.model, self.state.opt_state
        b1 = self.cfg['train']['optimizer']['b1']
        losses, grad_norms = [], {}
        for i in range(self.n_checked):
            losses.append(self._step()['loss'])
            if i == 0:
                grad_norms = {k: _first_moment_norm(opt, p) / (1 - b1)
                              for k, p in module.named_parameters()}
        change = {k: float((p.detach().float() - self.sd0[k]).norm())
                  for k, p in module.named_parameters()}
        self.program = {'losses': [float(x) for x in losses],
                        'grad_norms': grad_norms, 'change_norms': change}
        del self.sd0

    def window(self, seconds: float) -> Window:
        b = self.traffic['batch_size']
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            metrics = self._step()
            n += 1
        loss = float(metrics['loss'])
        elapsed = time.perf_counter() - t0
        if loss != loss:
            raise FloatingPointError('the loss is NaN at the window end')
        return Window(units=n, seconds=elapsed, attempted=n * b, failed=0,
                      metrics={'train_samples_per_s': n * b / elapsed})

    def stage_spans(self) -> Dict[str, float]:
        return {}

    def profiled_unit(self):
        self._step()

    def check(self) -> Dict[str, float]:
        del self.state, self.step, self.batches
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()
        return judge_against_reference(self.cfg, self.traffic, self.seed,
                                       self.dev, self.program)


def _reference_inputs(config, traffic, seed, device):
    v = config['vmae']
    sd = weights.vmae_state_dict(v, seed, device)
    batches = [make_batch(v, traffic, seed, c, device)
               for c in range(traffic['checked_steps'])]
    return sd, batches


def judge_against_reference(config, traffic, seed, device, program):
    sd, batches = _reference_inputs(config, traffic, seed, device)
    return ref_train.judge(sd, config['vmae'], config['train']['optimizer'],
                           batches, program)


def control(config: Dict, traffic: Dict, seed: int, device
            ) -> Dict[str, float]:
    """The output check's numbers with the float8 reference in the
    program's place."""
    sd, batches = _reference_inputs(config, traffic, seed, device)
    program = ref_train.reference_as_program(
        sd, config['vmae'], config['train']['optimizer'], batches,
        precision.FP8)
    return ref_train.judge(sd, config['vmae'], config['train']['optimizer'],
                           batches, program)


def fault_half_batch(config: Dict, traffic: Dict, seed: int, device
                     ) -> Dict[str, float]:
    """The numbers with the reference in the program's place taking the
    mean over the first half of each batch only."""
    sd, batches = _reference_inputs(config, traffic, seed, device)
    rows = range(traffic['batch_size'] // 2)
    program = ref_train.reference_as_program(
        sd, config['vmae'], config['train']['optimizer'], batches, rows=rows)
    return ref_train.judge(sd, config['vmae'], config['train']['optimizer'],
                           batches, program)
