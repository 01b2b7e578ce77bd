"""setup_ms: the frame loop's set-up of a frame, in ms: the worker's span
around ``setup_animation_frame`` and ``DevicePacker.pack_frame`` (the
harness's host clock), the mean over the window's frames."""


def read(run):
    items = {d.req.index for d in run.done}
    spans = [s for s in run.rec.spans if s.name == "frame_setup" and s.item in items]
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
