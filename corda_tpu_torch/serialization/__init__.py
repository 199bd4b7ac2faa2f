"""CBE serialization (counterpart of corda_tpu/serialization; the class
carpenter is not ported)."""

from .cbe import (
    GenericRecord,
    SerializationError,
    cbe_serializable,
    decode,
    deserialize,
    encode,
    register_custom,
    register_rename,
    serialize,
)

__all__ = [
    "GenericRecord",
    "SerializationError",
    "cbe_serializable",
    "decode",
    "deserialize",
    "encode",
    "register_custom",
    "register_rename",
    "serialize",
]
