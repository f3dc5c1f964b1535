from . import blur, color, effect, noise, streak
