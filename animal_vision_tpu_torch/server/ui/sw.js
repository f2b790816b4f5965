/* Service worker: cache-first app shell so the installed PWA opens offline
   (parity with vite-plugin-pwa's precache, ui/vite.config.ts). */
const CACHE = 'animal-vision-v2';
const SHELL = ['/ui', '/ui/app.js', '/ui/app.css', '/manifest.webmanifest'];
self.addEventListener('install', (e) => {
  e.waitUntil(caches.open(CACHE).then((c) => c.addAll(SHELL)));
  self.skipWaiting();
});
self.addEventListener('activate', (e) => { e.waitUntil(self.clients.claim()); });
self.addEventListener('fetch', (e) => {
  const url = new URL(e.request.url);
  if (e.request.method === 'GET' && SHELL.includes(url.pathname)) {
    e.respondWith(
      caches.match(e.request).then((hit) => hit ||
        fetch(e.request).then((resp) => {
          const copy = resp.clone();
          caches.open(CACHE).then((c) => c.put(e.request, copy));
          return resp;
        }))
    );
  }
});
