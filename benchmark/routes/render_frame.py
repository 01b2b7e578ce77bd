"""``render.render_frame``: the whole frame, samples [0, spp) of the
configuration, by the megakernel (K2), tonemapped on the device (the CLI's
frame)."""


def render(cfg, tables, req, route, device):
    from pathtracing_tpu_torch.render import render_frame

    if req.spp != cfg.samples_per_pixel or req.sample_base != 0:
        raise ValueError("render_frame renders samples [0, spp) of the config")
    return render_frame(cfg, tables, device=device)


def counter(route):
    from pathtracing_tpu_torch.ops import cuda_megakernel

    return cuda_megakernel
