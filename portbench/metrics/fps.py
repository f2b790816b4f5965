"""Frames completed over the window: every call's frames, each call ended
by ``torch.cuda.synchronize()``, over all the window's seconds."""


def read(r):
    return r.frames / r.window_s if r.window_s and r.frames else None
