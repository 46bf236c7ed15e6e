"""Test helper: libwebp's advanced encoder (WebPEncode with a WebPConfig)
through ctypes, from the libwebp that PIL bundles, for the VP8 options
PIL and cv2 do not expose: the simple loop filter, its sharpness and
strength, 1-4 segments, spatial noise shaping and token partitions.
``encode`` returns None where the library is not there."""

import ctypes
import glob
import os

import numpy as np

# the WebPConfig fields set here, as indices of its 4-byte fields
CFG = dict(lossless=0, quality=1, method=2, segments=6, sns_strength=7,
           filter_strength=8, filter_sharpness=9, filter_type=10,
           autofilter=11, partitions=18)
ABI = 0x0209              # an encoder ABI of libwebp's major version 2
_P, _I, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class MemWriter(ctypes.Structure):
    _fields_ = [("mem", _P), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", _U32 * 1)]


class Picture(ctypes.Structure):
    """WebPPicture, with room to spare at its end."""
    _fields_ = [("use_argb", _I), ("colorspace", _I), ("width", _I),
                ("height", _I), ("y", _P), ("u", _P), ("v", _P),
                ("y_stride", _I), ("uv_stride", _I), ("a", _P),
                ("a_stride", _I), ("pad1", _U32 * 2), ("argb", _P),
                ("argb_stride", _I), ("pad2", _U32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", _I),
                ("extra_info", _P), ("stats", _P), ("error_code", _I),
                ("progress_hook", _P), ("user_data", _P),
                ("pad3", _U32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", _U32 * 8), ("memory_", _P), ("memory_argb_", _P),
                ("pad7", _P * 2), ("spare", ctypes.c_uint8 * 256)]


def _lib():
    """libwebp from PIL's bundled libraries (libsharpyuv loaded first)."""
    import PIL

    d = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                     "pillow.libs")
    for dep in glob.glob(os.path.join(d, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    libs = glob.glob(os.path.join(d, "libwebp-*.so*"))
    return ctypes.CDLL(libs[0]) if libs else None


def encode(rgb, **kw):
    """WebP bytes of (h, w, 3) uint8 RGB with the WebPConfig fields in kw
    (CFG's names; quality a float), or None without the library."""
    lib = _lib()
    if lib is None:
        return None
    cfg = (ctypes.c_int32 * 128)()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(75.0), ABI)
    for k, v in kw.items():
        if k == "quality":
            ctypes.cast(ctypes.byref(cfg, 4 * CFG[k]),
                        ctypes.POINTER(ctypes.c_float))[0] = v
        else:
            cfg[CFG[k]] = v
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), kw
    pic = Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), ABI)
    h, w = rgb.shape[:2]
    pic.width, pic.height = w, h
    pic.use_argb = int(kw.get("lossless", 0))
    rgb = np.ascontiguousarray(rgb, np.uint8)
    assert lib.WebPPictureImportRGB(ctypes.byref(pic),
                                    rgb.ctypes.data_as(_P), w * 3)
    wr = MemWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, _P).value
    pic.custom_ptr = ctypes.cast(ctypes.byref(wr), _P).value
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    out = ctypes.string_at(wr.mem, wr.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    assert ok, pic.error_code
    return out
