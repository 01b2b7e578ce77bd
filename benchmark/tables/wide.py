"""The chunked w8 tables, as the CLI packs them on a CUDA device."""


def options() -> dict:
    from pathtracing_tpu_torch.accel.chunks import CHUNK_MAX

    return {"wide": True, "chunk_max": CHUNK_MAX}


def finish(tables):
    return tables
