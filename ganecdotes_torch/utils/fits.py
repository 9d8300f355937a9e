"""Minimal FITS image IO in numpy (the port's copy of
ganecdotes_tpu/utils/fits.py).

Single-HDU image FITS, written and read against the FITS standard:
2880-byte header blocks of 80-character cards, then the big-endian data
padded to a 2880-byte boundary (the reference reads and writes FITS through
astropy, which neither package needs).
"""

import numpy as np

_BLOCK = 2880
_CARD = 80

_BITPIX_TO_DTYPE = {
    8: ">u1",
    16: ">i2",
    32: ">i4",
    64: ">i8",
    -32: ">f4",
    -64: ">f8",
}
_DTYPE_TO_BITPIX = {
    np.dtype(np.uint8): 8,
    np.dtype(np.int16): 16,
    np.dtype(np.int32): 32,
    np.dtype(np.int64): 64,
    np.dtype(np.float32): -32,
    np.dtype(np.float64): -64,
}


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        body = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{key:<8}= {value:>20d}"
    elif isinstance(value, float):
        body = f"{key:<8}= {value:>20.13E}"
    else:
        body = f"{key:<8}= '{value}'"
    if comment:
        body += f" / {comment}"
    return body[:_CARD].ljust(_CARD)


def _parse_header(blocks):
    header = {}
    for i in range(0, len(blocks), _CARD):
        card = blocks[i : i + _CARD].decode("ascii", errors="replace")
        key = card[:8].strip()
        if key == "END":
            return header, True
        if "=" not in card:
            continue
        raw = card[9:].split("/")[0].strip()
        if raw.startswith("'"):
            header[key] = raw.strip("'").strip()
        elif raw in ("T", "F"):
            header[key] = raw == "T"
        else:
            try:
                header[key] = int(raw)
            except ValueError:
                try:
                    header[key] = float(raw)
                except ValueError:
                    header[key] = raw
    return header, False


def read_fits_data(input_file_name, field=0):
    """The image of HDU ``field`` (0: the primary) of a FITS file, as a
    numpy array in native byte order (BSCALE and BZERO applied)."""
    with open(input_file_name, "rb") as f:
        buf = f.read()
    pos = 0
    hdu = 0
    while pos < len(buf):
        header = {}
        done = False
        while not done:
            if pos >= len(buf):
                raise ValueError(
                    f"{input_file_name}: truncated FITS header (no END card)")
            header_part, done = _parse_header(buf[pos : pos + _BLOCK])
            header.update(header_part)
            pos += _BLOCK
        naxis = int(header.get("NAXIS", 0))
        shape = tuple(int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
        bitpix = int(header.get("BITPIX", 8))
        nbytes = abs(bitpix) // 8 * int(np.prod(shape)) if naxis else 0
        if hdu == field:
            if naxis == 0:
                return np.empty((0,))
            data = np.frombuffer(
                buf[pos : pos + nbytes], dtype=_BITPIX_TO_DTYPE[bitpix]
            ).reshape(shape)
            data = data.astype(data.dtype.newbyteorder("="))
            bscale = header.get("BSCALE", 1)
            bzero = header.get("BZERO", 0)
            if bscale != 1 or bzero != 0:
                data = data * bscale + bzero
            return data
        pos += -(-nbytes // _BLOCK) * _BLOCK
        hdu += 1
    raise IndexError(f"FITS file has no HDU {field}")


def save_fits_data(file_path, out_image):
    """A numpy image as a single-HDU FITS file (other dtypes as float32)."""
    arr = np.asarray(out_image)
    if arr.dtype not in _DTYPE_TO_BITPIX:
        arr = arr.astype(np.float32)
    bitpix = _DTYPE_TO_BITPIX[arr.dtype]

    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", bitpix),
        _card("NAXIS", arr.ndim),
    ]
    for i, n in enumerate(reversed(arr.shape)):
        cards.append(_card(f"NAXIS{i + 1}", int(n)))
    cards.append("END".ljust(_CARD))
    header = "".join(cards).encode("ascii")
    header += b" " * (-len(header) % _BLOCK)

    payload = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    payload += b"\x00" * (-len(payload) % _BLOCK)

    with open(file_path, "wb") as f:
        f.write(header)
        f.write(payload)
