"""Run a reference test's own code on the port: its function rebound to a
copy of its module's globals where chosen names are the port's and every
``import elephas_tpu...`` (at module level or inside the function)
resolves to ``elephas_tpu_torch...``. The test files of the port use it to
hold the port to the reference's cases without copying them."""

import builtins
import types


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and (name == "elephas_tpu" or name.startswith("elephas_tpu.")):
        name = "elephas_tpu_torch" + name[len("elephas_tpu"):]
    return builtins.__import__(name, globals, locals, fromlist, level)


_PORT_BUILTINS = dict(vars(builtins), __import__=_port_import)


def port_namespace(module, **names):
    """``module``'s globals with ``names`` in place of the reference's and
    the import hook above; the module's own functions are rebound to it, so
    the helpers a case calls run on the port too."""
    g = dict(vars(module), __builtins__=_PORT_BUILTINS, **names)
    for key, value in list(g.items()):
        if isinstance(value, types.FunctionType) and value.__module__ == module.__name__:
            g[key] = rebind(value, g)
    return g


def rebind(fn, g):
    """``fn`` with globals ``g`` (its marks and docstring kept)."""
    new = types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__, fn.__closure__)
    new.__dict__.update(fn.__dict__)
    new.__doc__ = fn.__doc__
    return new


def port_class(ref_cls, g, skip=(), only=None):
    """A class of ``ref_cls``'s test methods rebound to ``g``: those named in
    ``only`` (default: all), less ``skip``; its helper methods (``_name``)
    come along, rebound too."""
    methods = {name: rebind(fn, g) for name, fn in vars(ref_cls).items()
               if isinstance(fn, types.FunctionType) and (
                   (name.startswith("_") and not name.startswith("__"))
                   or (name.startswith("test_") and name not in skip
                       and (only is None or name in only)))}
    return type(ref_cls.__name__, (), {"__doc__": ref_cls.__doc__, **methods})
