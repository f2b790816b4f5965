"""Serving layer of the port: the ASGI app (REST, WebSocket, Socket.IO) and
its stdlib HTTP stack, on the CUDA card unless the caller passes a device."""
