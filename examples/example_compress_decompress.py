"""Example: compress and decompress a cloud with the CTC1 codec
(the reference's python/examples compress/decompress round trip)."""

import cwipc_util_jax as cwipc
from cwipc_util_jax import codec


def main() -> None:
    gen = cwipc.cwipc_synthetic(0, 40000)
    gen.start()
    pc = gen.get()
    gen.stop()
    assert pc is not None
    enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=9))
    enc.feed(pc)
    data = enc.get_bytes()
    print(f"{pc.count()} points ({pc.count() * 16} bytes raw) -> {len(data)} bytes compressed")
    dec = codec.cwipc_new_decoder()
    dec.feed(data)
    out = dec.get()
    print(f"decompressed to {out.count()} points")


if __name__ == "__main__":
    main()
