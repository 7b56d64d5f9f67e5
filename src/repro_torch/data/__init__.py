from repro_torch.data.synthetic import (SyntheticLM, calibration_batches,
                                        cloze_suite, make_batch_iterator)

__all__ = ["SyntheticLM", "calibration_batches", "cloze_suite",
           "make_batch_iterator"]
