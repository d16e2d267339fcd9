"""Data- and sample-parallel work over torch.distributed: meshes over the
ranks of the process group, the multi-process helpers, sample-sharded
counterfactuals and the row-sharded flow correlation. Port of
counterfactualworldmodels_tpu/parallel/ without tensor, pipeline and
sequence parallelism (the model-sharding slice)."""
from .mesh import (BatchSharding, make_mesh, replicate,
                   sample_parallel_mesh)
from .multihost import (host_local_batch_to_global, initialize_distributed,
                        make_hybrid_mesh, process_local_batch_size)
from .inference import (shard_counterfactual_batch, sharded_counterfactuals,
                        sharded_counterfactuals_fast,
                        sharded_counterfactuals_fast_multi,
                        sharded_imu_counterfactuals,
                        sharded_imu_counterfactuals_fast)
from .covariance import sharded_flow_corrs
