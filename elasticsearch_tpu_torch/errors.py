"""Typed errors of the port."""


class ParsingException(ValueError):
    """A malformed query or search body."""


class MapperParsingException(ValueError):
    """A mapping or document the mapper cannot take."""


class NotLowerable(ValueError):
    """A valid search the device path of this slice does not serve: the
    query is outside the lowering subset (match or/and/msm, term, terms,
    or a bool of should-terms on one text field), or the body asks for
    something beyond hits (sorting, aggregations, ...)."""


class IndexNotFound(KeyError):
    """No index of that name."""
