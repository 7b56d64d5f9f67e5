from repro_torch.config.base import (MULTI_POD, SHAPES, SINGLE_POD,
                                     SMOKE_SHAPES, SYNC_LEVELS, CommPolicy,
                                     MeshConfig, MLAConfig, ModelConfig,
                                     MoEConfig, ShapeConfig, SPDPlanConfig,
                                     SSMConfig, replace)

__all__ = ["MULTI_POD", "SHAPES", "SINGLE_POD", "SMOKE_SHAPES",
           "SYNC_LEVELS", "CommPolicy", "MeshConfig", "MLAConfig",
           "ModelConfig", "MoEConfig", "ShapeConfig", "SPDPlanConfig",
           "SSMConfig", "replace"]
