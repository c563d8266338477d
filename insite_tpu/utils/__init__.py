from insite_tpu.utils.profiling import (NoGPUError, card_info,
                                        device_record, require_gpus,
                                        time_blocked, trace,
                                        wall_clock_logger)
