# Copy of metaeuk_tpu/tax/__init__.py; it differs from its original only in this note.
