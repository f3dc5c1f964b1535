"""Import-time dependencies of the shared host layers.

``vkit_tpu.pipeline`` imports ``sklearn.neighbors.KDTree`` when the package
loads (text_detection/page_text_region.py and page_text_region_label.py),
and the page planner the port reuses sits inside that package.  Only the
text-region steps call KDTree; the port's slice never does.  Where
scikit-learn is not installed, a stand-in module lets the host layers
import, and its KDTree raises as soon as anything constructs one.
"""
import importlib.machinery
import importlib.util
import sys
import types


class _MissingKDTree:
    def __init__(self, *args, **kwargs):
        raise ModuleNotFoundError(
            'scikit-learn is not installed: sklearn.neighbors.KDTree (used by '
            "vkit_tpu's text-region steps) is unavailable"
        )


def _stand_in(name: str) -> types.ModuleType:
    module = types.ModuleType(name)
    # No origin: tools that probe installed packages (torch's trace rules)
    # see a module without files, and no submodule can be found in it.
    module.__spec__ = importlib.machinery.ModuleSpec(name, None)
    return module


def ensure_sklearn_importable():
    """Register the stand-in ``sklearn.neighbors`` if scikit-learn is
    absent; leave a real installation alone."""
    if 'sklearn' in sys.modules or importlib.util.find_spec('sklearn'):
        return
    sklearn = _stand_in('sklearn')
    neighbors = _stand_in('sklearn.neighbors')
    neighbors.KDTree = _MissingKDTree
    sklearn.neighbors = neighbors
    sys.modules['sklearn'] = sklearn
    sys.modules['sklearn.neighbors'] = neighbors
