from ._native import (available, crop_batch_native,  # noqa: F401
                      union_bbox_native, zscore_native)
