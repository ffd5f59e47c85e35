"""HTTP-on-Spark equivalent: HTTP as a first-class column type.

Reference L7 (SURVEY §2.6): ``io/http/`` — HTTPRequestData/HTTPResponseData
with row codecs (``HTTPSchema.scala``), client stack with async buffered
concurrency (``Clients.scala:12-63``), HTTPTransformer/SimpleHTTPTransformer
(``HTTPTransformer.scala:86-150``), parsers, SharedVariable.
"""

from .schema import (HTTPRequestData, HTTPResponseData, string_to_response,
                     request_to_string)
from .clients import AsyncClient, SingleThreadedClient
from .port_forwarding import SshTunnel, TcpForwarder
from .shared import SharedSingleton, SharedVariable
from .transformer import (CustomInputParser, CustomOutputParser,
                          HTTPTransformer, JSONInputParser,
                          JSONOutputParser, SimpleHTTPTransformer)

__all__ = ["SshTunnel", "TcpForwarder", "HTTPRequestData", "HTTPResponseData", "string_to_response",
           "request_to_string", "AsyncClient", "SingleThreadedClient",
           "SharedSingleton", "SharedVariable", "CustomInputParser",
           "CustomOutputParser", "HTTPTransformer", "JSONInputParser",
           "JSONOutputParser", "SimpleHTTPTransformer"]
