"""Host ms a frame spent inside the engine's ``step_async``: the
benchmark's span around each call, summed over the window outside its
profiler slices, over the frames handed to the engine there (every
stream's)."""


def read(run):
    if not run.get("dispatch_frames"):
        return None
    return 1e3 * run["dispatch_s"] / run["dispatch_frames"]
