"""Typed configuration framework (port of cruise_control_tpu/common/
config.py).

A Python re-design of the Kafka-style ConfigDef the reference vendors into its
core module (reference: cruise-control-core/src/main/java/com/linkedin/
cruisecontrol/common/config/ConfigDef.java:1-1253 and AbstractConfig).  It
provides typed key definitions with defaults, validators, importance and doc
strings; parsing from untyped dicts / properties files; and dynamic
instantiation of pluggable classes (the reference's getConfiguredInstance
pattern used for goals, samplers, notifiers, ...).  Host code only: the
REST layer's endpoint wiring keys (api/request_registry.py) are defined
through it.
"""
from __future__ import annotations

import enum
import importlib
import os
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional


class ConfigException(Exception):
    """Raised on invalid configuration (reference ConfigException)."""


class Type(enum.Enum):
    BOOLEAN = "boolean"
    STRING = "string"
    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    LIST = "list"
    CLASS = "class"
    PASSWORD = "password"


class Importance(enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


class Password:
    """Opaque secret wrapper that never prints its value
    (reference CORE/common/config/types/Password.java)."""

    def __init__(self, value: str):
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "[hidden]"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Password) and other.value == self.value

    def __hash__(self) -> int:
        return hash(self.value)


#: Sentinel meaning "no default — the key is required".
NO_DEFAULT = object()


Validator = Callable[[str, Any], None]


def in_range(min_value=None, max_value=None) -> Validator:
    """Range validator (reference ConfigDef.Range.between/atLeast)."""

    def validate(name: str, value: Any) -> None:
        if value is None:
            return
        if min_value is not None and value < min_value:
            raise ConfigException(f"{name}: value {value} must be >= {min_value}")
        if max_value is not None and value > max_value:
            raise ConfigException(f"{name}: value {value} must be <= {max_value}")

    return validate


def in_values(*allowed: Any) -> Validator:
    """Enumerated-value validator (reference ConfigDef.ValidString)."""

    def validate(name: str, value: Any) -> None:
        if value not in allowed:
            raise ConfigException(f"{name}: value {value!r} not in {allowed}")

    return validate


def non_empty(name: str, value: Any) -> None:
    if value is None or (isinstance(value, (str, list)) and not value):
        raise ConfigException(f"{name}: must be non-empty")


@dataclass
class ConfigKey:
    name: str
    type: Type
    default: Any = NO_DEFAULT
    validator: Optional[Validator] = None
    importance: Importance = Importance.MEDIUM
    doc: str = ""

    @property
    def has_default(self) -> bool:
        return self.default is not NO_DEFAULT


def _parse_bool(name: str, value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        lowered = value.strip().lower()
        if lowered == "true":
            return True
        if lowered == "false":
            return False
    raise ConfigException(f"{name}: expected boolean, got {value!r}")


def _parse_list(name: str, value: Any) -> List[Any]:
    if value is None:
        return []
    if isinstance(value, str):
        return [item.strip() for item in value.split(",") if item.strip()]
    if isinstance(value, (list, tuple)):
        return list(value)
    raise ConfigException(f"{name}: expected list, got {value!r}")


def parse_type(name: str, value: Any, expected: Type) -> Any:
    """Parse an untyped value to the declared type
    (reference ConfigDef.parseType)."""
    if value is None:
        return None
    try:
        if expected is Type.BOOLEAN:
            return _parse_bool(name, value)
        if expected is Type.STRING:
            return str(value)
        if expected in (Type.INT, Type.LONG):
            if isinstance(value, bool):
                raise ConfigException(f"{name}: expected int, got bool")
            return int(value)
        if expected is Type.DOUBLE:
            return float(value)
        if expected is Type.LIST:
            return _parse_list(name, value)
        if expected is Type.CLASS:
            return value  # resolved lazily by get_configured_instance
        if expected is Type.PASSWORD:
            return value if isinstance(value, Password) else Password(str(value))
    except (TypeError, ValueError) as exc:
        raise ConfigException(f"{name}: cannot parse {value!r} as {expected.value}: {exc}")
    raise ConfigException(f"{name}: unknown type {expected}")


class ConfigDef:
    """Registry of typed config keys (reference ConfigDef.java:1-1253)."""

    def __init__(self):
        self._keys: Dict[str, ConfigKey] = {}

    def define(self, name: str, type: Type, default: Any = NO_DEFAULT,
               validator: Optional[Validator] = None,
               importance: Importance = Importance.MEDIUM, doc: str = "") -> "ConfigDef":
        if name in self._keys:
            raise ConfigException(f"Config key {name} defined twice")
        if default is not NO_DEFAULT and default is not None:
            default = parse_type(name, default, type)
        self._keys[name] = ConfigKey(name, type, default, validator, importance, doc)
        return self

    def merge(self, other: "ConfigDef") -> "ConfigDef":
        for key in other._keys.values():
            if key.name not in self._keys:
                self._keys[key.name] = key
        return self

    def keys(self) -> Mapping[str, ConfigKey]:
        return dict(self._keys)

    def parse(self, props: Mapping[str, Any]) -> Dict[str, Any]:
        values: Dict[str, Any] = {}
        for name, key in self._keys.items():
            if name in props:
                value = parse_type(name, props[name], key.type)
            elif key.has_default:
                value = key.default
            else:
                raise ConfigException(f"Missing required configuration {name}")
            if key.validator is not None:
                key.validator(name, value)
            values[name] = value
        return values

    def document(self) -> str:
        """Render a markdown doc table of all keys (reference ConfigDef.toHtml)."""
        lines = ["| name | type | default | importance | doc |", "|---|---|---|---|---|"]
        for key in sorted(self._keys.values(), key=lambda k: k.name):
            default = "(required)" if not key.has_default else repr(key.default)
            lines.append(f"| {key.name} | {key.type.value} | {default} | "
                         f"{key.importance.value} | {key.doc} |")
        return "\n".join(lines)


def resolve_class(spec: Any):
    """Resolve a class from a "module.path:ClassName" or "module.path.ClassName"
    string, or pass through an actual class object."""
    if isinstance(spec, type):
        return spec
    if callable(spec) and not isinstance(spec, str):
        return spec
    if not isinstance(spec, str):
        raise ConfigException(f"Cannot resolve class from {spec!r}")
    module_name, _, cls_name = spec.replace(":", ".").rpartition(".")
    if not module_name:
        raise ConfigException(f"Class spec {spec!r} must be fully qualified")
    try:
        module = importlib.import_module(module_name)
        return getattr(module, cls_name)
    except (ImportError, AttributeError) as exc:
        raise ConfigException(f"Cannot load class {spec!r}: {exc}")


class AbstractConfig:
    """Parsed config values with typed accessors and pluggable-class
    instantiation (reference CORE/common/config/AbstractConfig.java)."""

    def __init__(self, definition: ConfigDef, props: Mapping[str, Any]):
        self.definition = definition
        self.originals = dict(props)
        self.values = definition.parse(props)
        self._used: set = set()

    def get(self, name: str) -> Any:
        if name not in self.values:
            raise ConfigException(f"Unknown configuration {name}")
        self._used.add(name)
        return self.values[name]

    def get_boolean(self, name: str) -> bool:
        return self.get(name)

    def get_int(self, name: str) -> int:
        return self.get(name)

    def get_long(self, name: str) -> int:
        return self.get(name)

    def get_double(self, name: str) -> float:
        return self.get(name)

    def get_string(self, name: str) -> str:
        return self.get(name)

    def get_list(self, name: str) -> List[Any]:
        return self.get(name)

    def unused(self) -> List[str]:
        return [k for k in self.originals if k not in self._used]

    def get_configured_instance(self, name: str, expected_type: type = object,
                                **extra) -> Any:
        """Instantiate the class named by config key `name` and, if it defines
        `configure(config_dict)`, pass it the full original config plus any
        `extra` overrides (reference AbstractConfig.getConfiguredInstance)."""
        cls = resolve_class(self.get(name))
        instance = cls()
        if not isinstance(instance, expected_type):
            raise ConfigException(
                f"{name}: {cls} is not an instance of {expected_type}")
        self._configure(instance, extra)
        return instance

    def get_configured_instances(self, name: str, expected_type: type = object,
                                 **extra) -> List[Any]:
        instances = []
        for spec in self.get_list(name):
            cls = resolve_class(spec)
            instance = cls()
            if not isinstance(instance, expected_type):
                raise ConfigException(
                    f"{name}: {cls} is not an instance of {expected_type}")
            self._configure(instance, extra)
            instances.append(instance)
        return instances

    def _configure(self, instance: Any, extra: Mapping[str, Any]) -> None:
        configure = getattr(instance, "configure", None)
        if callable(configure):
            merged = dict(self.originals)
            merged.update(extra)
            configure(merged)


#: ${env:NAME} indirection in property values (reference
#: CC/config/EnvConfigProvider.java — secrets such as passwords reference
#: environment variables instead of living in the properties file).
#: `$${env:NAME}` escapes the indirection, yielding a literal ${env:NAME}.
_ENV_REF = re.compile(r"(\$?)\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}")


def resolve_env_references(value: str) -> str:
    """Substitute every `${env:NAME}` in `value` from the environment.

    Unset variables raise (a silently-empty secret is worse than failing
    at startup).  A value that needs the literal text writes `$${env:...}`
    — the reference only substitutes via its explicitly-configured
    ConfigProvider, so an escape hatch is required here where resolution
    happens at load time."""
    def sub(match):
        if match.group(1):                   # $${env:X} -> literal ${env:X}
            return match.group(0)[1:]
        name = match.group(2)
        if name not in os.environ:
            raise KeyError(
                f"config references ${{env:{name}}} but {name} is not set")
        return os.environ[name]
    return _ENV_REF.sub(sub, value)


def load_properties(path: str) -> Dict[str, str]:
    """Parse a Java-style .properties file (reference reads config via
    KafkaCruiseControlUtils.readConfig), resolving ${env:NAME} secrets."""
    props: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as handle:
        for raw in handle:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith("!"):
                continue
            # first-occurring separator wins (Java .properties semantics)
            positions = [(line.index(sep), sep) for sep in ("=", ":")
                         if sep in line]
            if positions:
                pos, sep = min(positions)
                props[line[:pos].strip()] = resolve_env_references(
                    line[pos + len(sep):].strip())
    return props
