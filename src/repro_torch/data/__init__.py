from repro_torch.data.loader import ShardedLoader, to_device
from repro_torch.data.synthetic import (MixtureIterator, SyntheticConfig,
                                        calibration_batches)

__all__ = ["MixtureIterator", "ShardedLoader", "SyntheticConfig",
           "calibration_batches", "to_device"]
