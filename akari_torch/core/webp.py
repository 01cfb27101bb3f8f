"""WebP decoding without PIL: lossless (VP8L), lossy (VP8, with an ALPH
alpha plane) and the first frame of an animation.

The JAX package reads textures through PIL (``Image.open(path)
.convert("RGB")``), which opens WebP with libwebp's ``WebPAnimDecoder``
(``PIL/WebPImagePlugin.py``), even for a still image. ``decode_webp``
returns the [H, W, 3] uint8 pixels that decoder gives, and raises
``ValueError`` wherever it refuses the file:

- ``_features`` is libwebp's ``WebPGetFeatures`` (the header checks of
  ``src/dec/webp_dec.c``), which the decoder runs on the whole file and
  again on the frame it decodes;
- ``_demux`` is libwebp's demuxer (``src/demux/demux.c``): the RIFF size
  bounds the data (trailing bytes are ignored, a file shorter than its
  RIFF size is refused), chunks are padded to even sizes, ``VP8X`` gives
  the canvas and the feature flags (``ICCP``, ``EXIF``, ``XMP `` and
  unknown chunks are skipped; no orientation is applied), a still image
  is one ``VP8 `` or ``VP8L`` chunk (after one ``ALPH`` chunk for a lossy
  image, kept only when ``VP8X`` has the alpha flag) of the canvas's
  size, and an animation is ``ANIM`` then ``ANMF`` frames inside the
  canvas at offsets 2x, 2y;
- the frame is decoded by ``akari_torch/native/webp_vp8.cpp`` (lossy) or
  ``webp_vp8l.cpp`` (lossless), and its alpha plane, which never changes
  the RGB, is checked as libwebp decodes it (raw, or a headerless VP8L
  stream that must decode) and then dropped;
- frame 0 of an animation is placed on a zeroed canvas, so the RGB
  outside its rectangle is 0, as ``WebPAnimDecoder`` gives it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .image_formats import MAX_PIXELS  # PIL's limit, checked after libwebp allocates the canvas

# libwebp's limits and VP8X flags (src/webp/format_constants.h)
MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ANIMATION_FLAG, XMP_FLAG, EXIF_FLAG, ALPHA_FLAG, ICCP_FLAG = 0x02, 0x04, 0x08, 0x10, 0x20
ALL_VALID_FLAGS = ANIMATION_FLAG | XMP_FLAG | EXIF_FLAG | ALPHA_FLAG | ICCP_FLAG

_NOT_ENOUGH_DATA = "not enough data"


class _Refused(Exception):
    pass


def _le16(b, p):
    return b[p] | (b[p + 1] << 8)


def _le24(b, p):
    return b[p] | (b[p + 1] << 8) | (b[p + 2] << 16)


def _le32(b, p):
    return struct.unpack_from("<I", b, p)[0]


def _vp8_info(data, chunk_size):
    """VP8GetInfo: the frame size of a VP8 key frame, or None."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        return None
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    w = _le16(data, 6) & 0x3FFF
    h = _le16(data, 8) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        return None
    if w == 0 or h == 0:
        return None
    return w, h


def _vp8l_info(data):
    """VP8LGetInfo: (width, height, alpha hint) of a VP8L header, or None."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        return None
    bits = int.from_bytes(bytes(data[1:5]), "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _features(data, have_all_data=False):
    """ParseHeadersInternal: libwebp's header checks of a file or of a
    frame's chunks (``have_all_data`` as ``WebPDecode`` passes it). Returns
    a dict (``offset`` of the codec data, ``lossless``, ``alpha`` as
    (start, size) of an ALPH payload, the frame's ``size``); raises
    ``_Refused``."""
    size = len(data)
    if size < 12:
        raise _Refused(_NOT_ENOUGH_DATA)
    pos, riff_size = 0, 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise _Refused("no WEBP signature")
        riff_size = _le32(data, 4)
        if riff_size < 12 or riff_size > MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {riff_size}")
        if have_all_data and riff_size > size - 8:
            raise _Refused(_NOT_ENOUGH_DATA)
        pos = 12
    if size - pos < 8:
        raise _Refused(_NOT_ENOUGH_DATA)
    vp8x, flags, canvas = False, 0, (0, 0)
    if data[pos:pos + 4] == b"VP8X":
        if _le32(data, pos + 4) != 10:
            raise _Refused(f"VP8X chunk of {_le32(data, pos + 4)} bytes")
        if size - pos < 18:
            raise _Refused(_NOT_ENOUGH_DATA)
        flags = _le32(data, pos + 8)
        canvas = (1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15))
        if canvas[0] * canvas[1] >= MAX_IMAGE_AREA:
            raise _Refused(f"canvas {canvas[0]} x {canvas[1]}")
        pos += 18
        vp8x = True
    animation = bool(flags & ANIMATION_FLAG)
    if vp8x and not riff_size:
        raise _Refused("VP8X outside RIFF")
    result = {"offset": None, "lossless": False, "alpha": None, "size": canvas}
    if vp8x and animation and not have_all_data:
        return result

    def short():  # libwebp's ReturnWidthHeight for data that ends early
        if vp8x and not have_all_data:
            return result
        raise _Refused(_NOT_ENOUGH_DATA)

    if size - pos < 4:
        return short()
    if (riff_size and vp8x) or (not riff_size and not vp8x and data[pos:pos + 4] == b"ALPH"):
        total = 4 + 8 + 10
        while True:  # ParseOptionalChunks
            if size - pos < 8:
                return short()
            chunk = _le32(data, pos + 4)
            if chunk > MAX_CHUNK_PAYLOAD:
                raise _Refused(f"chunk of {chunk} bytes")
            disk = (8 + chunk + 1) & ~1
            total += disk
            if riff_size and total > riff_size:
                raise _Refused("chunks past the RIFF size")
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if size - pos < disk:
                return short()
            if data[pos:pos + 4] == b"ALPH":
                result["alpha"] = (pos + 8, chunk)
            pos += disk
    if size - pos < 8:  # ParseVP8Header
        return short()
    tag = bytes(data[pos:pos + 4])
    if tag in (b"VP8 ", b"VP8L"):
        compressed = _le32(data, pos + 4)
        if riff_size >= 12 and compressed > riff_size - 12:
            raise _Refused(f"{tag.decode()} chunk of {compressed} bytes past the RIFF size")
        if have_all_data and compressed > size - pos - 8:
            raise _Refused(_NOT_ENOUGH_DATA)
        pos += 8
        lossless = tag == b"VP8L"
    else:
        lossless = _vp8l_info(data[pos:]) is not None
        compressed = size - pos
    if compressed > MAX_CHUNK_PAYLOAD:
        raise _Refused(f"chunk of {compressed} bytes")
    body = data[pos:]
    if not lossless:
        if len(body) < 10:
            return short()
        frame = _vp8_info(body, compressed)
        if frame is None:
            raise _Refused("not a VP8 key frame")
    else:
        if len(body) < 5:
            return short()
        info = _vp8l_info(body)
        if info is None:
            raise _Refused("not a VP8L header")
        frame = info[:2]
    if vp8x and canvas != frame:
        raise _Refused(f"image {frame[0]} x {frame[1]} on a canvas of {canvas[0]} x {canvas[1]}")
    result.update(offset=pos, lossless=lossless, size=frame)
    return result


class _Frame:
    def __init__(self):
        self.x, self.y, self.width, self.height = 0, 0, 0, 0
        self.image = (0, 0)  # (offset, size) of the VP8/VP8L chunk, header included
        self.alpha = (0, 0)  # the same of the ALPH chunk
        self.frame_num = 0
        self.complete = False


class _Demuxer:
    """libwebp's demuxer (src/demux/demux.c, WebPDemux without partial
    data): the canvas, the flags and the frames of a complete file."""

    def __init__(self, data):
        if len(data) < 20:
            raise _Refused(_NOT_ENOUGH_DATA)
        if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise _Refused("no RIFF WEBP header")
        riff_size = _le32(data, 4)
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {riff_size}")
        self.data = data
        self.riff_end = riff_size + 8
        if len(data) < self.riff_end:
            raise _Refused(f"file of {len(data)} bytes, its RIFF size says {self.riff_end}")
        self.end = self.riff_end  # bytes past the RIFF chunk are ignored
        self.start = 12
        self.ext = False
        self.flags = 0
        self.canvas = (-1, -1)
        self.frames = []
        tag = data[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            status, valid = self._single_image(), self._valid_simple
        elif tag == b"VP8X":
            status, valid = self._vp8x(), self._valid_extended
        else:
            raise _Refused(f"first chunk {bytes(tag)!r}")
        if status != "ok":  # a complete file that needs more data is corrupt
            raise _Refused(f"chunks that {status}")
        if not valid():
            raise _Refused("chunks libwebp's demuxer refuses")

    def _avail(self):
        return self.end - self.start

    def _size_invalid(self, size):
        return size > self.riff_end - self.start

    def _u32(self):
        v = _le32(self.data, self.start)
        self.start += 4
        return v

    def _u24(self):
        v = _le24(self.data, self.start)
        self.start += 3
        return v

    def _store_frame(self, frame_num, min_size, frame):
        """StoreFrame: one ALPH and one VP8/VP8L chunk into ``frame``."""
        if self._avail() < 8 or self._avail() < min_size:
            return "need more data"
        alpha_chunks = image_chunks = 0
        status = "ok"
        while True:
            chunk_start = self.start
            fourcc = self.data[self.start:self.start + 4]
            self.start += 4
            payload = self._u32()
            if payload > MAX_CHUNK_PAYLOAD:
                return "error"
            padded = payload + (payload & 1)
            available = min(padded, self._avail())
            chunk_size = 8 + available
            if self._size_invalid(padded):
                return "error"
            if padded > self._avail():
                status = "need more data"
            stop = False
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha = (chunk_start, chunk_size)
                frame.frame_num = frame_num
                self.start += available
            elif fourcc in (b"VP8 ", b"VP8L") and (fourcc == b"VP8 " or not alpha_chunks):
                if image_chunks:
                    stop = True
                else:
                    try:
                        feats = _features(self.data[chunk_start:chunk_start + chunk_size])
                    except _Refused as e:
                        if status != "ok" and str(e) == _NOT_ENOUGH_DATA:
                            return "need more data"
                        return "error"
                    image_chunks = 1
                    frame.image = (chunk_start, chunk_size)
                    frame.width, frame.height = feats["size"]
                    frame.frame_num = frame_num
                    frame.complete = status == "ok"
                    self.start += available
            elif fourcc == b"VP8L":  # after ALPH: VP8L has its own alpha
                return "error"
            else:
                stop = True
            if stop:
                self.start -= 8
                break
            if self.start == self.riff_end:
                break
            if self._avail() < 8:
                status = "need more data"
            if status != "ok":
                break
        return status

    def _add_frame(self, frame):
        if self.frames and not self.frames[-1].complete:
            return False
        self.frames.append(frame)
        return True

    def _single_image(self):
        if self.frames or self._size_invalid(8):
            return "error"
        if self._avail() < 8:
            return "need more data"
        frame = _Frame()
        status = self._store_frame(1, 0, frame)
        if status != "error":
            if not self.flags & ALPHA_FLAG and frame.alpha[1] > 0:
                frame.alpha = (0, 0)  # the alpha plane is dropped without the flag
            if not self.ext and frame.width > 0 and frame.height > 0:
                self.canvas = (frame.width, frame.height)
            if not self._add_frame(frame):
                status = "error"
        return status

    def _vp8x(self):
        if self._avail() < 8:
            return "need more data"
        self.ext = True
        self.start += 4
        size = self._u32()
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            return "error"
        size += size & 1
        if self._size_invalid(size):
            return "error"
        if self._avail() < size:
            return "need more data"
        self.flags = self.data[self.start]
        self.start += 4
        self.canvas = (1 + self._u24(), 1 + self._u24())
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            return "error"
        self.start += size - 10
        if self._size_invalid(8):
            return "error"
        if self._avail() < 8:
            return "need more data"
        return self._vp8x_chunks()

    def _vp8x_chunks(self):
        is_animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        status = "ok"
        while status == "ok":
            fourcc = self.data[self.start:self.start + 4]
            self.start += 4
            size = self._u32()
            if size > MAX_CHUNK_PAYLOAD:
                return "error"
            padded = size + (size & 1)
            if self._size_invalid(padded):
                return "error"
            if fourcc == b"VP8X":
                return "error"
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or is_animation:  # frames of an animation are in ANMF
                    return "error"
                self.start -= 8
                status = self._single_image()
            elif fourcc == b"ANIM" and anim_chunks == 0:
                if padded < 6:
                    return "error"
                if self._avail() < padded:
                    status = "need more data"
                else:
                    anim_chunks = 1
                    self.start += padded  # background colour, loop count
            elif fourcc == b"ANIM" and padded < 6:
                return "error"
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return "error"
                status = self._animation_frame(padded)
            elif padded <= self._avail():  # ICCP, EXIF, XMP, a second ANIM, unknown
                self.start += padded
            else:
                status = "need more data"
            if self.start == self.riff_end:
                break
            if self._avail() < 8:
                status = "need more data"
        return status

    def _animation_frame(self, chunk_size):
        if self._size_invalid(16) or chunk_size < 16:
            return "error"
        if self._avail() < 16:
            return "need more data"
        frame = _Frame()
        frame.x = 2 * self._u24()
        frame.y = 2 * self._u24()
        frame.width = 1 + self._u24()
        frame.height = 1 + self._u24()
        self.start += 4  # duration, dispose and blend bits
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            return "error"
        payload = chunk_size - 16
        start = self.start
        status = self._store_frame(len(self.frames) + 1, payload, frame)
        if status != "error" and self.start - start > payload:
            status = "error"
        if status != "error" and self.flags & ANIMATION_FLAG and frame.frame_num > 0:
            if not self._add_frame(frame):
                status = "error"
        return status

    def _valid_simple(self):
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            return False
        f = self.frames[0]
        return f.width > 0 and f.height > 0

    def _valid_extended(self):
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            return False
        if self.flags & ~ALL_VALID_FLAGS:
            return False
        for f in self.frames:
            if not is_animation and f.frame_num > 1:
                return False
            if not f.complete:  # no partial frame in a complete file
                return False
            if f.alpha[1] == 0 and f.image[1] == 0:
                return False
            if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                return False
            if f.width <= 0 or f.height <= 0:
                return False
            cw, ch = self.canvas
            if not is_animation:
                if f.x or f.y or (f.width, f.height) != (cw, ch):
                    return False
            elif f.x < 0 or f.y < 0 or f.width + f.x > cw or f.height + f.y > ch:
                return False
        return True

    def first_frame(self):
        """The first frame's bytes (its ALPH chunk, if kept, then its image
        chunk), as WebPDemuxGetFrame gives them."""
        f = self.frames[0]
        start, size = f.image
        if f.alpha[1] > 0:
            inter = f.image[0] - (f.alpha[0] + f.alpha[1]) if f.image[0] > 0 else 0
            start = f.alpha[0]
            size += f.alpha[1] + inter
        return f, self.data[start:start + size]


def _check_alpha(data, start, size, width, height, what):
    """ALPHInit / ALPHDecode: the alpha plane must decode; its values are
    dropped, as ``convert("RGB")`` drops them."""
    if size <= 1:
        raise ValueError(f"{what}: WebP alpha chunk of {size} bytes")
    head = data[start]
    method, pre, reserved = head & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"{what}: WebP alpha header {head:#04x} (compression {method}, "
                         f"pre-processing {pre}, reserved bits {reserved})")
    if method == 0:
        if size - 1 < width * height:
            raise ValueError(f"{what}: raw WebP alpha of {size - 1} bytes for {width} x {height}")
        return
    from ..native.loader import load

    stream = bytes(data[start + 1:start + size])
    if load("webp_vp8l").akr_vp8l_decode(stream, len(stream), width, height, 1, None):
        raise ValueError(f"{what}: corrupt lossless WebP alpha data")


def _decode_frame(frag, what):
    """WebPDecode of one frame's bytes -> [h, w, 3] uint8."""
    from ..native.loader import load

    try:
        _features(frag)
        hdr = _features(frag, have_all_data=True)
    except _Refused as e:
        raise ValueError(f"{what}: WebP frame refused by libwebp's checks ({e})") from None
    w, h = hdr["size"]
    body = bytes(frag[hdr["offset"]:])
    if hdr["lossless"]:
        argb = np.empty((h, w), np.uint32)
        rc = load("webp_vp8l").akr_vp8l_decode(body, len(body), w, h, 0,
                                               argb.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise ValueError(f"{what}: corrupt lossless WebP (VP8L) data")
        b = argb.view(np.uint8).reshape(h, w, 4)
        return np.ascontiguousarray(b[..., 2::-1])  # BGRA in memory -> RGB
    rgb = np.empty((h, w, 3), np.uint8)
    rc = load("webp_vp8").akr_vp8_decode(body, len(body), w, h,
                                         rgb.ctypes.data_as(ctypes.c_void_p))
    if rc:
        faults = {1: "a bad frame header", 2: "partition sizes past the data",
                  3: "the first partition ending inside the modes",
                  4: "a token partition ending inside the coefficients"}
        raise ValueError(f"{what}: corrupt lossy WebP (VP8) data: {faults.get(rc, rc)}")
    if hdr["alpha"] is not None:
        _check_alpha(frag, *hdr["alpha"], w, h, what)
    return rgb


def decode_webp(data, what="image"):
    """WebP file bytes -> [H, W, 3] uint8, the pixels of PIL's
    ``convert("RGB")`` (frame 0 of an animation on its canvas)."""
    data = memoryview(data).cast("B")
    try:
        _features(data)  # WebPAnimDecoderNew checks the file first
        dmux = _Demuxer(data)
    except _Refused as e:
        raise ValueError(f"{what}: WebP file refused by libwebp's checks ({e})") from None
    cw, ch = dmux.canvas
    if cw * ch > MAX_PIXELS:
        raise ValueError(f"{what}: WebP canvas of {cw} x {ch} (more pixels than PIL opens)")
    frame, frag = dmux.first_frame()
    px = _decode_frame(frag, what)
    if (frame.x, frame.y, frame.width, frame.height) == (0, 0, cw, ch):
        return px
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[frame.y:frame.y + frame.height, frame.x:frame.x + frame.width] = px
    return canvas
