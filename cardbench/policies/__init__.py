"""One file a geometric distortion policy, found by the policy's name
(``policies/<policy>.py``): ``sample(level, shape, rng)``, a frozen copy
of the policy's config sampler, and ``geometry(config, shape)``, the warp
that the config describes worked out in plain NumPy, for the reference."""
