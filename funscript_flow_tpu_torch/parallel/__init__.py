"""Device lists (``mesh``) that one clip's windows take turns over."""
