"""A tiny configuration and cells of the benchmark's drivers that run on
the CPU in seconds, for the benchmark's own tests."""
import copy

from cwm_bench import harness

TINY_VMAE = {
    'img_size': 128, 'patch_size': 16, 'tubelet_size': 1, 'num_frames': 2,
    'in_chans': 3, 'encoder_embed_dim': 64, 'encoder_depth': 2,
    'encoder_num_heads': 4, 'decoder_embed_dim': 32, 'decoder_depth': 2,
    'decoder_num_heads': 4, 'mlp_ratio': 4.0, 'qkv_bias': True}


def tiny_cell(name: str, traffic=None) -> harness.Cell:
    """The cell ``name`` with its configuration cut to the tiny model: f32,
    128 px, 16 x 16 patches (an 8 x 8 grid, which pools of 4 divide; RAFT's
    coarsest level is 2 x 2), RAFT
    at 2 iterations; its traffic cut by ``traffic``."""
    cell = harness.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg['dtype'] = 'float32'
    cfg['vmae'] = dict(TINY_VMAE)
    cfg['raft'] = dict(cfg['raft'], iters=2)
    spec = copy.deepcopy(cell.spec)
    spec['traffic'].update(traffic or {})
    return harness.Cell(cell.name, cell.workload, spec, cfg,
                        cell.end_to_end, cell.per_layer)


CF_TRAFFIC = {'num_samples': 4, 'sample_batch_size': 4, 'passive': 8,
              'warmup_calls': 1, 'check_rows': 3}
TRAIN_TRAFFIC = {'batch_size': 2}
