"""The reference renderer's animated scene: 18 meshes (17 of them
stand-ins, ``benchmark/harness/inputs.py``), the placement of its 945
instances, and per frame the animation track's creatures, cameras and
sunset light in every motion-blur subframe."""

from benchmark.harness import inputs


def write_inputs(folder) -> str:
    return inputs.write_animation_meshes(folder)


class Program:
    """``load_scene`` and a ``DevicePacker``; per request the CLI's frame
    set-up: ``setup_animation_frame`` then ``pack_frame``."""

    def __init__(self, cfg, tables, data_dir, device, rec):
        from pathtracing_tpu_torch.scene.device import DevicePacker
        from pathtracing_tpu_torch.scene.loader import load_scene

        self.cfg, self.tables, self.rec = cfg, tables, rec
        with rec.span("load_scene"):
            self.scene = load_scene(data_dir=data_dir, config=cfg, device=device)
        with rec.span("device_packer"):
            self.packer = DevicePacker(self.scene, device=device, **tables.options())

    def prepare(self, req):
        from pathtracing_tpu_torch.scene.loader import setup_animation_frame

        with self.rec.span("frame_setup", req.index):
            with self.rec.span("setup_animation_frame", req.index):
                setup_animation_frame(self.scene, req.frame, self.cfg)
            with self.rec.span("pack_frame", req.index):
                return self.tables.finish(self.packer.pack_frame(self.scene))


def reference(cfg, data_dir, device, lowp=None):
    from benchmark.reference.scene import AnimatedScene

    anim = AnimatedScene(data_dir, device)
    return lambda index: anim.frame(index, cfg, lowp=lowp)
