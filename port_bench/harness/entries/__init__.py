"""The entries a traffic file can name: each drives one entry point of the
port through set-up, the window and the traced window, and compares what
it produced with the reference."""
