"""Scale-defining constants of the DHT (the system's "model dimensions").

Mirrors the reference's tuning constants so behavior/convergence match:

- TARGET_NODES (k=8): ref include/opendht/routing_table.h:26
- SEARCH_NODES (14): ref include/opendht/dht.h:314
- MAX_REQUESTED_SEARCH_NODES (alpha=4): ref include/opendht/dht.h:327
- request timeout 1 s x 3 attempts: ref include/opendht/node.h:97,
  include/opendht/request.h:113
- rate limits: ref include/opendht/network_engine.h:462,596-600
- storage limits: ref include/opendht/callbacks.h:72, dht.h:333-339
- liveness timings: ref include/opendht/node.h:91-94, dht.h:341-351
"""

# --- Kademlia dimensions ---------------------------------------------------
TARGET_NODES = 8              # k: bucket size / replication factor
SEARCH_NODES = 14             # nodes tracked per search
MAX_REQUESTED_SEARCH_NODES = 4  # alpha: in-flight requests per search
SEARCH_MAX_BAD_NODES = 25     # consecutive expired nodes => connectivity loss

# --- network engine --------------------------------------------------------
MAX_RESPONSE_TIME = 1.0       # seconds per request attempt
MAX_ATTEMPT_COUNT = 3         # retransmits before EXPIRED
BLACKLIST_EXPIRE_TIME = 10 * 60  # misbehaving peers sit out 10 min
# The blacklist is a bounded set of misbehaving peers (SURVEY §4: "LRU
# of misbehaving peers") — a cap keeps an attacker cycling source
# addresses from growing it without bound; soonest-to-expire entries
# are evicted first when full.
MAX_BLACKLIST_SIZE = 1024
MAX_REQUESTS_PER_SEC = 1600   # global inbound rate limit
MAX_REQUESTS_PER_SEC_PER_IP = 200
MAX_PACKET_VALUE_SIZE = 8 * 1024   # larger values are fragmented
MTU = 1280                    # bytes per value part packet
MAX_VALUE_SIZE = 64 * 1024
RX_MAX_PACKET_TIME = 10.0     # total reassembly window
RX_TIMEOUT = 3.0              # inter-part reassembly timeout
MAX_MESSAGE_VALUE_COUNT = 50  # more values than this => header + parts
AGENT = "RNG1"                # wire agent tag, packed as msgpack str (ref src/network_engine.cpp:43)

# --- storage ---------------------------------------------------------------
MAX_STORAGE_SIZE = 64 * 1024 * 1024
MAX_HASHES = 16384
MAX_VALUES = 1024
MAX_SEARCHES = 2048

# --- liveness & maintenance (seconds) --------------------------------------
NODE_GOOD_TIME = 120 * 60     # replied within => good
NODE_EXPIRE_TIME = 10 * 60    # not heard within => dubious
SEARCH_EXPIRE_TIME = 62 * 60
LISTEN_EXPIRE_TIME = 30.0     # remote listener refresh period
REANNOUNCE_MARGIN = 10.0
SEARCH_GET_TIMEOUT = 3.0
SEARCH_RETRY_MIN_INTERVAL = 10.0
MAX_STORAGE_MAINTENANCE_EXPIRE_TIME = 10 * 60
TOKEN_EXPIRE_TIME = 15 * 60   # secret rotation 15-45 min
BOOTSTRAP_RETRY_PERIOD = 10.0
NODE_MAX_AUTH_ERRORS = 3
