"""The error an image file that cannot be read raises."""


class ImageReadError(FileNotFoundError, ValueError):
    """A file ``read_image_rgb`` or one of its decoders cannot read: not an
    image kind it knows, a kind it does not decode, or a corrupt or
    truncated one. It is a FileNotFoundError, as the JAX package raises
    when cv2.imread returns None (data/labels.py), so callers that catch
    that around train(), val() or image_predict(path) behave the same; and
    a ValueError, as the port raised before. The message names the file."""
