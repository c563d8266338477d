from insite_tpu.ops.pallas_rollout import (kernels_default,
                                           pallas_batched_rollout,
                                           pallas_rollout_with_sens)
