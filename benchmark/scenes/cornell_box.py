"""The Cornell box: 32 triangles in one instance, its emissive ceiling
panel sampled as an area light, no sun. Static: every request renders the
same tables."""

import os

from benchmark.harness import inputs


def write_inputs(folder) -> str:
    inputs.write_cornell(folder)
    return str(folder)


class Program:
    """``models.build("cornell_box")``, once."""

    def __init__(self, cfg, tables, data_dir, device, rec):
        from pathtracing_tpu_torch import models

        with rec.span("load_scene"):
            _, static = models.build("cornell_box", cfg, asset_dir=data_dir,
                                     wide=tables.options()["wide"], device=device)
        self.static = tables.finish(static)

    def prepare(self, req):
        return self.static


def reference(cfg, data_dir, device, lowp=None):
    from benchmark.reference.scene import cornell_box

    path = os.path.join(data_dir, "cornell.obj")
    return lambda index: cornell_box(path, cfg, device, lowp=lowp)
