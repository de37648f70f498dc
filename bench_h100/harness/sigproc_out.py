"""The benchmark's own SIGPROC header writer: the inputs owe nothing to the
code under test."""

from __future__ import annotations

import struct


def _word(s):
    b = s.encode("ascii")
    return struct.pack("<i", len(b)) + b


def write_header(config, ibeam):
    """The header of beam ``ibeam`` of a pointing of ``config``."""
    out = _word("HEADER_START")
    out += _word("source_name") + _word(config["name"])
    for key, value in (("telescope_id", config.get("telescope_id", 4)),
                       ("machine_id", config.get("machine_id", 0)),
                       ("data_type", 1), ("nchans", config["nchans"]),
                       ("nbits", config["nbits"]), ("nifs", 1),
                       ("nbeams", len(config["beams"])), ("ibeam", ibeam)):
        out += _word(key) + struct.pack("<i", int(value))
    for key, value in (("tstart", config.get("tstart", 60000.0)),
                       ("tsamp", config["tsamp"]), ("fch1", config["fch1"]),
                       ("foff", config["foff"])):
        out += _word(key) + struct.pack("<d", float(value))
    return out + _word("HEADER_END")
