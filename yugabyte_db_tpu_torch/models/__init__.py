"""The data model: types, primitive values, document keys, schema,
partitioning. Pure host-side Python/numpy, byte-identical to the JAX
package's ``models`` (held so by tests/test_torch_models.py)."""

from yugabyte_db_tpu_torch.models.datatypes import DataType
from yugabyte_db_tpu_torch.models.schema import ColumnKind, ColumnSchema, Schema
from yugabyte_db_tpu_torch.models.encoding import (
    encode_key_component,
    decode_key_component,
    encode_doc_key,
    decode_doc_key,
)
from yugabyte_db_tpu_torch.models.partition import PartitionSchema, Partition
