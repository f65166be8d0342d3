"""ANSI terminal colour (parity: reference utils/colour.py).

``cstring(s, ...)`` wraps a string in colour codes; ``cprint`` prints it.
A module-level current colour is settable via ``cset``.

A copy of ``pypulsar_tpu/utils/colour.py``
(the port imports nothing of the JAX package).
"""

DEFAULT_CODE = "\033[0;39;49m"

preset_codes = {
    "default": DEFAULT_CODE,
    "reset": DEFAULT_CODE,
    "debug": "\033[0;33m",
    "warning": "\033[0;33m",
    "error": "\033[1;31m",
}

attributes = {
    "reset": 0,
    "bold": 1,
    "dim": 2,
    "underline": 4,
    "blink": 5,
    "reverse": 7,
    "hidden": 8,
}

fg_colours = {
    "black": 30, "red": 31, "green": 32, "brown": 33, "blue": 34,
    "purple": 35, "cyan": 36, "white": 37, "default": 39,
}

bg_colours = {
    "black": 40, "red": 41, "green": 42, "brown": 43, "blue": 44,
    "purple": 45, "cyan": 46, "white": 47, "default": 49,
}

current_code = DEFAULT_CODE


def make_code(preset=None, fg="default", bg="default", **attr):
    """Build an ANSI escape code from a preset name or fg/bg/attributes."""
    if preset is not None:
        if preset not in preset_codes:
            raise ValueError("Unrecognized preset color code: %s" % preset)
        return preset_codes[preset]

    set_attr = []
    for a, on in attr.items():
        if a not in attributes:
            raise ValueError("Unrecognized attribute: %s" % a)
        if on:
            set_attr.append(str(attributes[a]))
    if not set_attr:
        set_attr = ["0"]

    if fg in fg_colours:
        fg_val = str(fg_colours[fg])
    elif isinstance(fg, int) or str(fg).isdigit():
        fg_val = str(fg)
    else:
        raise ValueError("Unrecognized foreground colour: %s" % fg)

    if bg in bg_colours:
        bg_val = str(bg_colours[bg])
    elif isinstance(bg, int) or str(bg).isdigit():
        bg_val = str(bg)
    else:
        raise ValueError("Unrecognized background colour: %s" % bg)

    return "\033[%s;%s;%sm" % (";".join(set_attr), fg_val, bg_val)


def cset(preset=None, fg="default", bg="default", **attr):
    """Set the module-level current colour."""
    global current_code
    current_code = make_code(preset=preset, fg=fg, bg=bg, **attr)


def creset():
    """Reset the current colour to the default."""
    global current_code
    current_code = DEFAULT_CODE


def cstring(s, *args, **kwargs):
    """Return ``s`` wrapped in the requested (or current) colour code."""
    code = make_code(*args, **kwargs) if (args or kwargs) else current_code
    return "%s%s%s" % (code, s, DEFAULT_CODE)


def cprint(s, *args, **kwargs):
    """Print ``s`` in colour."""
    print(cstring(s, *args, **kwargs))
