"""The C ABI of the port: the header, the shim's source, its build and ctypes bindings."""
