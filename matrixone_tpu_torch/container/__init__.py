from matrixone_tpu_torch.container import dtypes
from matrixone_tpu_torch.container.batch import Batch, from_device
from matrixone_tpu_torch.container.device import (DeviceBatch, DeviceColumn,
                                                  bucket_length, from_numpy)
from matrixone_tpu_torch.container.dtypes import DType, TypeOid
from matrixone_tpu_torch.container.vector import Vector

__all__ = ["dtypes", "Batch", "from_device", "DeviceBatch", "DeviceColumn",
           "bucket_length", "from_numpy", "DType", "TypeOid", "Vector"]
