from repro_torch.config.base import (SYNC_LEVELS, CommPolicy, MLAConfig,
                                     ModelConfig, MoEConfig, SPDPlanConfig,
                                     SSMConfig, replace)

__all__ = ["SYNC_LEVELS", "CommPolicy", "MLAConfig",
           "ModelConfig", "MoEConfig", "SPDPlanConfig", "SSMConfig",
           "replace"]
