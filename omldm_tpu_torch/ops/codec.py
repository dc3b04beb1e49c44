"""Wire accounting of the transport codec.

Counterpart of ``omldm_tpu/ops/codec.py``'s constants: the bytes a
parameter element takes on the wire, and the per-leaf metadata, for each
codec. The SPMD engine prices its collectives with them
(``SPMDTrainer.protocol_traffic_bytes``). The codec itself -- the host
kernels and the SPMD engine's quantize-dequantize twins -- is not ported
yet: the control gate refuses ``comm.codec``, and :func:`make_qdq` takes
only ``"none"``.
"""

from __future__ import annotations

# wire bytes per parameter element, by codec kind (the int8 affine meta --
# scale + zero point, two float32 -- is accounted per LEAF, not per element)
BYTES_PER_ELEMENT = {"none": 4.0, "fp16": 2.0, "int8": 1.0}
# per-leaf metadata bytes on the wire
LEAF_META_BYTES = {"none": 0, "fp16": 0, "int8": 8}


def make_qdq(name: str):
    """The SPMD step's quantize-dequantize function for a codec: None for
    ``"none"`` (the exact step); every other codec is not ported yet."""
    if str(name).lower() == "none":
        return None
    raise NotImplementedError(f"comm.codec {name!r} is not yet ported")
