"""Data-, sample-, tensor-, sequence- and pipeline-parallel work over
torch.distributed: meshes over the ranks of the process group and the
partition rules, the multi-process helpers, the tensor-parallel modules
and encoder stacks, sample-sharded counterfactuals and the row-sharded flow
correlation. Port of counterfactualworldmodels_tpu/parallel/."""
from .mesh import (CONJOINED_PARTITION_RULES, VMAE_PARTITION_RULES,
                   BatchSharding, Split, make_mesh, opt_state_shardings,
                   param_shardings, partition_spec_for, replicate,
                   sample_parallel_mesh, shard_params)
from .multihost import (host_local_batch_to_global, initialize_distributed,
                        make_hybrid_mesh, process_local_batch_size)
from .tensor import (copy_to_tp, full_state_dict, make_tp_encoder_forward,
                     reduce_from_tp, stack_block_params,
                     tensor_parallel_blocks, unstack_block_params)
from .sequence import make_sp_encoder_forward, sequence_parallel_blocks
from .pipeline import make_pp_encoder_forward, pipelined_blocks
from .inference import (shard_counterfactual_batch, sharded_counterfactuals,
                        sharded_counterfactuals_fast,
                        sharded_counterfactuals_fast_multi,
                        sharded_imu_counterfactuals,
                        sharded_imu_counterfactuals_fast)
from .covariance import sharded_flow_corrs
