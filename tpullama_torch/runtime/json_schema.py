"""JSON schema → GBNF grammar conversion.

The capability analog of common/json-schema-to-grammar.cpp (response-
format constrained decoding): supports type keywords (object/array/
string/number/integer/boolean/null), properties/required/
additionalProperties, items/prefixItems/minItems/maxItems, enum/const,
anyOf/oneOf, allOf (merged), $ref/$defs/definitions, string
minLength/maxLength, integer minimum/maximum (digit-range
approximation). Output is validated by our own GBNF engine
(tests assert acceptance semantics rather than golden text).
"""

from __future__ import annotations

import json
import re

_SPACE = "space"

_PRIMITIVES = {
    "boolean": '("true" | "false") space',
    "null": '"null" space',
    "number": '("-"? ([0-9] | [1-9] [0-9]{0,15})) ("." [0-9]+)? ([eE] [-+]? [0-9] [1-9]{0,15})? space',
    "integer": '("-"? ([0-9] | [1-9] [0-9]{0,15})) space',
    "string": r'"\"" char* "\"" space',
    "char": r'[^"\\\x7F\x00-\x1F] | [\\] (["\\bfnrt] | "u" [0-9a-fA-F]{4})',
    "value": "object | array | string | number | boolean | null",
    "object": '"{" space ( string ":" space value ("," space string ":" space value)* )? "}" space',
    "array": '"[" space ( value ("," space value)* )? "]" space',
    _SPACE: '| " " | "\\n"{1,2} [ \\t]{0,20}',
}


def _escape_literal(s: str) -> str:
    out = []
    for ch in s:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\t":
            out.append("\\t")
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


def _json_literal_rule(value) -> str:
    """Grammar matching exactly the JSON serialization of `value`."""
    text = json.dumps(value, ensure_ascii=False)
    return _escape_literal(text) + " space"


class SchemaConverter:
    def __init__(self):
        self.rules: dict[str, str] = {_SPACE: _PRIMITIVES[_SPACE]}
        self._counters: dict[str, int] = {}
        self.root_schema = None

    def _add_rule(self, name: str, body: str) -> str:
        base = re.sub(r"[^a-zA-Z0-9-]+", "-", name) or "rule"
        if base in self.rules and self.rules[base] != body:
            i = self._counters.get(base, 0)
            while f"{base}{i}" in self.rules and self.rules[f"{base}{i}"] != body:
                i += 1
            self._counters[base] = i
            base = f"{base}{i}"
        self.rules[base] = body
        return base

    def _add_primitive(self, name: str) -> str:
        if name not in self.rules:
            self.rules[name] = _PRIMITIVES[name]
            # pull in dependencies
            deps = {
                "string": ["char"],
                "value": ["object", "array", "string", "number", "boolean", "null"],
                "object": ["string", "value"],
                "array": ["value"],
            }
            for d in deps.get(name, []):
                self._add_primitive(d)
        return name

    def _resolve_ref(self, ref: str):
        if not ref.startswith("#/"):
            raise ValueError(f"only local $refs supported, got {ref!r}")
        node = self.root_schema
        for part in ref[2:].split("/"):
            node = node[part]
        return node

    def visit(self, schema: dict | bool, name: str = "root") -> str:
        if schema is True or schema == {}:
            self._add_primitive("value")
            return self._add_rule(name, "value")
        if schema is False:
            raise ValueError("unsatisfiable schema: false")

        if "$ref" in schema:
            target = self._resolve_ref(schema["$ref"])
            ref_name = schema["$ref"].split("/")[-1]
            return self.visit(target, ref_name)

        if "const" in schema:
            return self._add_rule(name, _json_literal_rule(schema["const"]))
        if "enum" in schema:
            alts = " | ".join(_json_literal_rule(v) for v in schema["enum"])
            return self._add_rule(name, alts)

        for comb in ("oneOf", "anyOf"):
            if comb in schema:
                subs = [self.visit(s, f"{name}-{i}") for i, s in enumerate(schema[comb])]
                return self._add_rule(name, " | ".join(subs))
        if "allOf" in schema:
            merged: dict = {}
            for s in schema["allOf"]:
                if "$ref" in s:
                    s = self._resolve_ref(s["$ref"])
                for k, v in s.items():
                    if k == "properties":
                        merged.setdefault("properties", {}).update(v)
                    elif k == "required":
                        merged["required"] = sorted(set(merged.get("required", [])) | set(v))
                    else:
                        merged[k] = v
            return self.visit(merged, name)

        stype = schema.get("type")
        if isinstance(stype, list):
            subs = [self.visit({**schema, "type": t}, f"{name}-{t}") for t in stype]
            return self._add_rule(name, " | ".join(subs))

        if stype == "object" or (stype is None and "properties" in schema):
            return self._add_rule(name, self._object_rule(schema, name))
        if stype == "array" or (stype is None and ("items" in schema or "prefixItems" in schema)):
            return self._add_rule(name, self._array_rule(schema, name))
        if stype == "string":
            return self._add_rule(name, self._string_rule(schema))
        if stype in ("number", "integer", "boolean", "null"):
            return self._add_primitive(stype)
        # untyped
        self._add_primitive("value")
        return self._add_rule(name, "value")

    def _object_rule(self, schema: dict, name: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        addl = schema.get("additionalProperties", True)
        parts = []
        for pname, pschema in props.items():
            prule = self.visit(pschema, f"{name}-{pname}")
            kv = f'{_escape_literal(json.dumps(pname))} space ":" space {prule}'
            parts.append((pname, kv, pname in required))
        if not parts:
            if addl is False:
                return '"{" space "}" space'
            self._add_primitive("object")
            return "object"
        # constrained-output property order: required props in declared
        # order, then optionals (each individually omittable with its comma)
        rule = ['"{" space']
        req = [p for p in parts if p[2]]
        opt = [p for p in parts if not p[2]]
        if req:
            core = req[0][1]
            for _, kv, _ in req[1:]:
                core += f' "," space {kv}'
            for _, kv, _ in opt:
                core += f' ( "," space {kv} )?'
            rule.append(core)
        else:
            # all optional: ( p1 ("," p2)? ("," p3)? ... | p2 ("," p3)? ... | ... )?
            alts = []
            for i in range(len(opt)):
                s = opt[i][1]
                for j in range(i + 1, len(opt)):
                    s += f' ( "," space {opt[j][1]} )?'
                alts.append(s)
            rule.append("( " + " | ".join(alts) + " )?")
        rule.append('"}" space')
        return " ".join(rule)

    def _array_rule(self, schema: dict, name: str) -> str:
        if "prefixItems" in schema:
            subs = [self.visit(s, f"{name}-{i}") for i, s in enumerate(schema["prefixItems"])]
            inner = ' "," space '.join(subs)
            return f'"[" space {inner} "]" space'
        items = schema.get("items", True)
        sub = self.visit(items, f"{name}-item") if items is not True else self._add_primitive("value")
        min_items = schema.get("minItems", 0)
        max_items = schema.get("maxItems")
        if min_items == 0 and max_items is None:
            return f'"[" space ( {sub} ( "," space {sub} )* )? "]" space'
        if max_items is None:
            reps = f'{sub} ( "," space {sub} ){{{min_items - 1},}}' if min_items > 1 else f'{sub} ( "," space {sub} )*'
            return f'"[" space {reps} "]" space'
        if min_items == 0:
            return f'"[" space ( {sub} ( "," space {sub} ){{0,{max_items - 1}}} )? "]" space'
        return f'"[" space {sub} ( "," space {sub} ){{{min_items - 1},{max_items - 1}}} "]" space'

    def _string_rule(self, schema: dict) -> str:
        self._add_primitive("char")
        fmt = schema.get("format")
        if fmt == "date":
            return '"\\"" [0-9]{4} "-" [0-9]{2} "-" [0-9]{2} "\\"" space'
        if fmt == "time":
            return '"\\"" [0-9]{2} ":" [0-9]{2} ":" [0-9]{2} "\\"" space'
        if fmt == "date-time":
            return ('"\\"" [0-9]{4} "-" [0-9]{2} "-" [0-9]{2} "T" [0-9]{2} ":" [0-9]{2} ":" '
                    '[0-9]{2} ("Z" | [+-] [0-9]{2} ":" [0-9]{2}) "\\"" space')
        if fmt == "uuid":
            return ('"\\"" [0-9a-fA-F]{8} "-" [0-9a-fA-F]{4} "-" [0-9a-fA-F]{4} "-" '
                    '[0-9a-fA-F]{4} "-" [0-9a-fA-F]{12} "\\"" space')
        min_len = schema.get("minLength", 0)
        max_len = schema.get("maxLength")
        if min_len or max_len is not None:
            if max_len is not None:
                rep = f"{{{min_len},{max_len}}}"
            elif min_len:
                rep = f"{{{min_len},}}"
            else:
                rep = "*"
            return f'"\\"" char{rep} "\\"" space'
        return '"\\"" char* "\\"" space'

    def to_gbnf(self) -> str:
        lines = []
        for name, body in self.rules.items():
            lines.append(f"{name} ::= {body}")
        return "\n".join(lines) + "\n"


def json_schema_to_gbnf(schema: dict | str) -> str:
    """Convert a JSON schema to GBNF (root rule = the schema)."""
    if isinstance(schema, str):
        schema = json.loads(schema)
    conv = SchemaConverter()
    conv.root_schema = schema
    root = conv.visit(schema, "root")
    if root != "root":
        conv.rules["root"] = root
    return conv.to_gbnf()
