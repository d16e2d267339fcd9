"""Generate ``docs/API_torch.md``: the port's public API, module by module.

Port of the JAX package's ``scripts/gen_api_doc.py``: it imports each of
the port's modules and writes each public class (with its public methods)
and function with its signature and the first line of its docstring, so a
reader can browse the surface without importing anything. Re-run it after
adding API. A module that fails to import raises (the JAX script writes a
note in its place and goes on).

    python -m counterfactualworldmodels_tpu_torch.scripts.gen_api_doc \\
        --device cpu
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import os
import re

from .._device import resolve_device

PKG = 'counterfactualworldmodels_tpu_torch'
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (module, one-line intro) in presentation order
MODULES = [
    ('', 'Top-level re-exports and ``resolve_device``.'),
    ('models.vmae', 'Masked video autoencoder (VMAE) model and the released '
                    'configurations.'),
    ('models.conjoined', 'Two-stream (RGB + context/IMU) conjoined VMAE.'),
    ('models.cmae', 'ChannelMAE family (channel-partitioned image MAE) and '
                    'the Soft variants.'),
    ('models.transformer', 'Generic transformer blocks (cross/self '
                           'attention).'),
    ('models.preprocessor', 'Stream preprocessor registry (rgb01, flow, '
                            'imu, ...).'),
    ('models.layers', 'ViT building blocks (patch embed, attention, MLP).'),
    ('models.fast_vmae', 'Shared-prefix counterfactual engine (frame-0 '
                         'prefix cached per scene).'),
    ('models.fast_conjoined', 'Conjoined (IMU-conditioned) shared-prefix '
                              'engine.'),
    ('models.raft.raft', 'RAFT optical flow (correlation volume + GRU '
                         'refinement).'),
    ('models.raft.corr', 'Correlation pyramid and the fused window lookup '
                         '(a CUDA kernel on the card).'),
    ('masking.generators', 'Mask generator family.'),
    ('masking.mask_ops', 'Mask post-processing (upsample, distances, '
                         'partitions, rectangularize).'),
    ('pipelines.prediction', 'PredictorBasedGenerator: masked prediction '
                             'wrapper API.'),
    ('pipelines.segmentation', 'FlowGenerator: counterfactual videos, '
                               'flows, motion covariance.'),
    ('pipelines.movability', 'MovabilityPredictor: iterated counterfactual '
                             'sampling.'),
    ('pipelines.imu', 'IMU-conditioned generators (two-model pipeline).'),
    ('pipelines.perturbation', 'Counterfactual constructions (shifts, '
                               'statics, markers).'),
    ('pipelines.filters', 'FlowSampleFilter: reject degenerate flow '
                          'samples.'),
    ('pipelines.patch_selector', 'Energy-based interactive patch '
                                 'selection.'),
    ('interface', 'Interactive matplotlib interface.'),
    ('serve', 'HTTP server over the generators.'),
    ('training.train', 'Training steps and optimizers for VMAE / conjoined '
                       '/ ChannelMAE.'),
    ('training.raft', 'RAFT flow training (sequence loss, synthetic warp '
                      'batches, distillation).'),
    ('training.loop', 'The trainers\' shared loop.'),
    ('training.train_vmae', 'The VMAE trainer.'),
    ('training.train_cmae', 'The ChannelMAE trainer.'),
    ('training.train_conjoined', 'The conjoined trainer.'),
    ('training.train_raft', 'The RAFT trainer.'),
    ('training.flops', 'FLOPs of the training steps (the trainers\' MFU).'),
    ('data.shards', 'Shard format and the native (C++) clip loader with IMU '
                    'sidecars.'),
    ('data.utils', 'Image/video IO helpers and demo utilities.'),
    ('parallel', 'Process groups, meshes, sharded training and inference, '
                 'tp/sp/pp stacks.'),
    ('kernels', 'Build, load and count the hand-written CUDA kernels.'),
    ('ops.flash_attention', 'Attention through the CUDA kernels (single and '
                            'two-source prefix), with plain versions.'),
    ('ops.layer_norm', 'The residual add + LayerNorm pass through its CUDA '
                       'kernel.'),
    ('ops.linear', 'The block linears with their bias and GELU in the '
                   'product\'s epilogue; the qkv pass through its CUDA '
                   'kernel.'),
    ('ops.patches', 'Patchify / unpatchify.'),
    ('ops.pos_embed', 'Sin-cos positional embeddings.'),
    ('ops.flow_viz', 'Optical-flow color wheel rendering.'),
    ('ops.normalization', 'ImageNet (un)normalization.'),
    ('ops.sampling', 'Energy-weighted patch sampling.'),
    ('ops.coords', 'Coordinate grids and patch/pixel index maps.'),
    ('ops.resize', 'Bilinear resize.'),
    ('ops.misc', 'Misc tensor utilities mirrored from the reference.'),
    ('utils.weights', 'Reference-layout state dicts: seeded weights and the '
                      'bridge from JAX params.'),
    ('utils.checkpoint', 'Checkpointing with rolling resume.'),
    ('utils.profiling', 'Trace capture, the span registry and the '
                        'metrics log.'),
    ('utils.batching', 'Leader-follower micro-batching (serving).'),
    ('utils.backend_guard', 'Device liveness probe.'),
    ('utils.cache', 'Kernel build cache.'),
    ('utils.png', 'PNG writing without PIL or matplotlib.'),
    ('utils.colormaps', 'The inferno and RdBu_r colour tables.'),
    ('vis_utils', 'Plotting helpers (imshow grids, mask overlays).'),
    ('scripts.extract_structure', 'Structure extraction with the Soft '
                                  'ChannelMAE.'),
    ('scripts.make_shards', 'Videos, frame directories and arrays into '
                            'CWMSHARD files.'),
    ('scripts.fidelity_report', 'Shared-prefix engine fidelity against the '
                                'exact model.'),
    ('scripts.demo_counterfactuals', 'The demo: factual prediction, '
                                     'counterfactuals, motion maps, '
                                     'movability.'),
    ('scripts.gen_api_doc', 'This generator.'),
    ('scripts._bench_common', 'The measurement entry points\' shared '
                              'prompts, timing windows and peak.'),
    ('scripts.bench', 'Counterfactual simulations per second (the '
                      'dispatch), with the S probe and the rung ladder.'),
    ('scripts.bench_sweep', 'The bench over several sample counts S.'),
    ('scripts.latency_bench', 'p50 / p99 latency of a prediction, a click '
                              'and an IMU click.'),
    ('scripts.serve_latency', 'First-request latency per prompt size '
                              'through the service.'),
    ('scripts.loadgen', 'Serving throughput under concurrent clients, '
                        'micro-batching on and off.'),
    ('scripts.bench_conjoined', 'The IMU-conditioned counterfactual on both '
                                'engines.'),
    ('scripts.bench_train', 'Training steps/s, clips/s and MFU per '
                            'family.'),
    ('scripts.bench_loader', 'The native clip loader against the Python '
                             'one.'),
    ('scripts.bench_attention', 'The decoder-suffix attention candidates '
                                '(K1, K2, SDPA, plain).'),
]


def _sig(obj):
    """The signature, without the memory addresses of default objects (so
    the file only changes when the API does)."""
    try:
        return re.sub(r' at 0x[0-9a-f]+', '', str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return '(...)'


def _doc1(obj):
    d = inspect.getdoc(obj)
    if not d:
        return ''
    return d.strip().split('\n')[0].strip()


def _public_members(mod):
    fns, classes = [], []
    for name in sorted(dir(mod)):
        if name.startswith('_'):
            continue
        obj = getattr(mod, name)
        home = getattr(obj, '__module__', None) or ''
        # only symbols defined in (or re-exported into) the package
        if inspect.ismodule(obj) or not home.startswith(PKG):
            continue
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif callable(obj):
            fns.append((name, obj))
    return classes, fns


def render_module(modname: str, intro: str, out: list) -> None:
    full = PKG if modname == '' else f'{PKG}.{modname}'
    mod = importlib.import_module(full)
    classes, fns = _public_members(mod)
    if not classes and not fns:
        return
    out.append(f'## `{full}`\n')
    out.append(intro + '\n')
    for name, cls in classes:
        out.append(f'### class `{name}{_sig(cls)}`\n')
        d = _doc1(cls)
        if d:
            out.append(d + '\n')
        meths = []
        for m, fn in sorted(vars(cls).items()):
            if m.startswith('_'):
                continue
            target = fn.__func__ if isinstance(fn, (staticmethod,
                                                    classmethod)) else fn
            if not callable(target):
                continue
            meths.append(f'- `.{m}{_sig(target)}`'
                         + (f' — {_doc1(target)}' if _doc1(target) else ''))
        if meths:
            out.extend(meths)
            out.append('')
    for name, fn in fns:
        d = _doc1(fn)
        out.append(f'- **`{name}{_sig(fn)}`**' + (f' — {d}' if d else ''))
    out.append('')


def render() -> str:
    out = [
        '# API reference (PyTorch port)',
        '',
        f'`{PKG}` public surface, module by module. Generated by',
        f'`python -m {PKG}.scripts.gen_api_doc`: regenerate after API',
        'changes. `docs/API.md` is the JAX package\'s.',
        '',
    ]
    for modname, intro in MODULES:
        render_module(modname, intro, out)
    return '\n'.join(out).rstrip() + '\n'


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', default=os.path.join(_ROOT, 'docs',
                                                  'API_torch.md'))
    ap.add_argument('--device', default='cuda',
                    help='resolved as every entry point\'s is; the '
                         'generator itself runs on the host')
    args = ap.parse_args(argv)
    resolve_device(args.device)
    text = render()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        f.write(text)
    print(f'wrote {args.out} ({len(text.splitlines())} lines)')
    return args.out


if __name__ == '__main__':
    main()
