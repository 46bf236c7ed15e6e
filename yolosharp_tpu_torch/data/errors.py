"""The error an image file that cannot be read raises."""


class ImageReadError(FileNotFoundError, ValueError):
    """A file ``read_image_rgb`` or one of its decoders cannot read: not an
    image kind it knows, a kind it does not decode, or a corrupt or
    truncated one. It is a FileNotFoundError, as the JAX package raises
    when cv2.imread returns None (data/labels.py), so callers that catch
    that around train(), val() or image_predict(path) behave the same; and
    a ValueError, as the port raised before. The message names the file."""


# cv2.imread's limits (CV_IO_MAX_IMAGE_WIDTH / HEIGHT / PIXELS): past them
# it raises before decoding
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def check_size(width: int, height: int, name: str) -> None:
    """Raise ImageReadError for an image cv2.imread will not allocate."""
    if width > MAX_SIDE or height > MAX_SIDE or width * height > MAX_PIXELS:
        raise ImageReadError(f"{name}: a {width}x{height} image is past "
                             f"cv2.imread's size limits")
