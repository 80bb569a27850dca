"""Overlap record flag bits (.las `flags` field), the values of
damar_tpu.formats.oflags."""

# Dazzler core (align.h lineage)
OVL_COMP = 0x1        # B read is reverse-complemented
OVL_ACOMP = 0x2       # A read complemented (only in sym-swapped records)

# MARVEL scrubbing/graph extensions
OVL_DISCARD = 0x4     # drop from further processing
OVL_SYMDISCARD = 0x8  # discard mirrored record too
OVL_LOCAL = 0x10      # local (non-dovetail, non-containment) alignment
OVL_CONT = 0x20       # containment (A or B contained)
OVL_STITCH = 0x40     # produced by stitching fragments
OVL_TRIM = 0x80       # adjusted by trim track
OVL_GAP = 0x100       # spans/abuts a pile gap
OVL_REPEAT = 0x200    # repeat-induced (no unique anchor)
OVL_OLEN = 0x400      # failed overlap-length filter
OVL_RLEN = 0x800      # failed read-length filter
OVL_TEMP = 0x1000     # transient marker used inside tools

FLAG_NAMES = {
    OVL_COMP: "comp", OVL_ACOMP: "acomp", OVL_DISCARD: "discard",
    OVL_SYMDISCARD: "symdiscard", OVL_LOCAL: "local", OVL_CONT: "cont",
    OVL_STITCH: "stitch", OVL_TRIM: "trim", OVL_GAP: "gap",
    OVL_REPEAT: "repeat", OVL_OLEN: "olen", OVL_RLEN: "rlen",
    OVL_TEMP: "temp",
}


def flag_str(flags: int) -> str:
    """The names of the set bits, comma-separated ("-" when none)."""
    return ",".join(n for b, n in FLAG_NAMES.items() if flags & b) or "-"
