"""The halo configuration's CPU size, beside the sizes in
``portbench_small``: an 8^3 lattice with the largest halo capped so it fits,
the background mesh a quarter of the lattice as at 256^3, rendered into
24^3 so that the render's dense pass has rows."""
import portbench_small

portbench_small.SMALL_CONFIG.setdefault(
    "camels-halos", {"particles": 8 ** 3, "halo_n_max": 128,
                     "background_mesh": 2})
portbench_small.SMALL_TRAFFIC.setdefault("render-sph-1024", {"grid": 24})
