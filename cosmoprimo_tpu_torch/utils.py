"""General utilities (the part of cosmoprimo_tpu/utils.py this port needs)."""


def addproperty(*attrs):
    """Class decorator adding read-only properties exposing ``self._<attr>``."""

    def decorator(cls):
        def make_prop(name):
            return property(lambda self: getattr(self, '_' + name))
        for attr in attrs:
            setattr(cls, attr, make_prop(attr))
        return cls

    return decorator
