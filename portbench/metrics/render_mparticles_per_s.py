"""render_mparticles_per_s: particles rendered over the whole window, in
millions, divided by the window (host clock)."""


def read(host: dict):
    if host["unit"] != "particles":
        return None
    return host["work"] / host["window_s"] / 1e6
