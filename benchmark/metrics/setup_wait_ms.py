"""setup_wait_ms: the time per frame, in ms, that the render loop blocked
on the worker's set-up of the frame (the set-up not hidden behind the
previous frame's render): the harness's span around the future's result,
the mean over the window's frames."""


def read(run):
    items = {d.req.index for d in run.done}
    spans = [s for s in run.rec.spans if s.name == "setup_wait" and s.item in items]
    if not spans or not any(s.name == "frame_setup" for s in run.rec.spans):
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)
