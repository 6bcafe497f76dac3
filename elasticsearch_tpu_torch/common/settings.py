"""Flat, typed settings.

Copy of the reference's ``common/settings.py`` ``Settings`` map (the
typed ``Setting`` registry and the scoped validators are left out): an
immutable flat key → value map, nested dicts flattened to dotted keys, so
a node or index configuration written for the reference reads the same
here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.common.errors import SettingsException


class Settings:
    """Immutable flat key→value map. Nested dicts flatten to dotted keys."""

    EMPTY: "Settings"

    def __init__(self, flat: Optional[Dict[str, Any]] = None):
        self._map: Dict[str, Any] = dict(flat or {})

    @staticmethod
    def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in d.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out.update(Settings._flatten(v, key + "."))
            else:
                out[key] = v
        return out

    @classmethod
    def of(cls, d: Optional[Dict[str, Any]] = None, **kwargs: Any) -> "Settings":
        merged = dict(d or {})
        merged.update(kwargs)
        return cls(cls._flatten(merged))

    @staticmethod
    def normalize_index_settings(d: Optional[Dict[str, Any]]
                                 ) -> Dict[str, Any]:
        """Flatten an index-settings body accepting both spellings — bare
        keys ("number_of_shards") and prefixed ("index.number_of_shards")
        — into the canonical index.-prefixed flat form."""
        out: Dict[str, Any] = {}
        for k, v in Settings._flatten(d or {}).items():
            out[k if k.startswith("index.") else f"index.{k}"] = v
        return out

    def get(self, key: str, default: Any = None) -> Any:
        return self._map.get(key, default)

    def get_as_dict(self) -> Dict[str, Any]:
        return dict(self._map)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._map.get(key)
        return default if v is None else int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._map.get(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        """Strict boolean parsing: only true/false are accepted."""
        v = self._map.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        s = str(v).lower()
        if s == "true":
            return True
        if s == "false":
            return False
        raise SettingsException(
            f"Failed to parse value [{v}] for setting [{key}]: "
            f"only [true] or [false] are allowed")

    def __repr__(self):
        return f"Settings({self._map!r})"


Settings.EMPTY = Settings()
