from . import affine, camera, mls
